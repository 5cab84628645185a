#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build the eight kernel libraries (``exciting_environments_torch/csrc/
   stepper.cu``, ``pmsm_stepper.cu``, ``closed_loop.cu``,
   ``pmsm_closed_loop.cu``, ``pmsm_closed_loop_adjoint.cu``,
   ``pmsm_angles.cu``, ``pendulum_fast.cu`` and ``pmsm_fast.cu``; the
   stepper and closed-loop libraries with one translation unit per
   environment, ``csrc/stepper/*.cu`` and ``csrc/closed_loop/*.cu``, the
   PMSM closed loop with its actor's in ``csrc/pmsm_closed_loop/actor.cu``), one
   nvcc per source, all started together, then one link per library, and
   report the whole build time, the longest single nvcc and each compiler
   resource report;
2. hold the stepper kernel against its plain PyTorch version on the card at
   B = 65,536, T = 64, float32, in every mode the port uses, and its action
   ring: a batch-major slab read in place, next rows across tile
   boundaries (sim-ahead, hold 2), a horizon that ends inside a tile, slabs
   whose rows are no 16-byte multiples (element-wise copies, ragged B) and
   a float64 case;
3. replay the pendulum golden fixture (``tests/envs/pendulum/data``) through
   the kernel in float64 and check it with the fixture test's own allclose;
4. drive the pendulum main path: ``Pendulum(batch_size=65536, tau=1e-4)`` and
   ``env.fused_rollout`` over T = 4,096 steps in float32, in both action
   layouts, plus ``env.fused_sim_ahead`` (RK4) at the same size; show through
   the launch counts that it ran the kernel, time it with CUDA events and
   compare it with the plain version on the same inputs; check that a
   batch-major slab is read in place (the kernel agrees with the time-major
   read, and the entry point allocates less than the slab); report the
   kernel's anatomy (see below) for rows 1a and 1b;
5. check the PMSM kernel's ``atan2f`` and the hexagon's sine sign bits
   against ``torch.atan2``/``torch.sin`` on the card (2^28 seeded pairs, the
   axes and special values, the sector edges); then hold the PMSM kernel,
   which takes the normalized actions and runs the angle, the
   environment's constraint and the deadtime buffer itself, against its
   plain version (the eager pre-pass, then the step loop) at B = 65,536,
   T = 64, float32 (and float64 cases), tolerance 0.0, over the motor
   variants, solvers, deadtimes, per-batch parameters, DC link and action
   band, saves, both slab layouts, sim-ahead in both deadtimes and a
   ragged B;
6. replay the PMSM golden fixture (``tests/envs/pmsm/data``) through the
   kernel in one float64 launch, checked with the fixture test's allclose;
7. drive the PMSM main path: ``PMSM(batch_size=65536, saturated=True,
   motor_variant=BRUSA, tau=1e-4)``, ``env.fused_rollout`` over T = 256 in
   both layouts and with ``obs_stride=16``, and ``env.fused_sim_ahead``
   (RK4), with the eager pre-pass's functions counted (none may run on the
   card) and one launch per call; shapes, kernel vs plain at full size, the
   entry points against their kernel, the kernel alone at T = 4,096 and on
   a holding fleet inside its current bands, and the anatomy (rows 3a-3b);
8. hold the closed-loop kernel (``csrc/closed_loop.cu``, the policy inside
   the loop) against its plain version at B = 65,536, T = 64, float32 (and
   one float64 case), tolerance 0.0: PD and PI laws (``AffinePolicy``) on
   the pendulum over Euler and RK4, CartPole Tsit5, MassSpringDamper Heun,
   per-batch lengths, injected noise slabs, the PPO actor exploring and
   deterministic, a ragged B and ``obs_stride = 4``;
9. drive the closed-loop main path: ``Pendulum(batch_size=65536,
   control_state=["theta"])`` tracking ``linspace(-1.5, 1.5)`` with the PD
   law and with the PI law through ``env.fused_closed_loop`` over
   T = 4,096, and the exploring actor (hidden (16, 16), ``tau = 2e-2``)
   through ``RolloutCollector.collect_policy_fused`` over T = 64; each with
   the launch count set to 0 just before and read just after, kernel vs
   plain at full size, kernel and entry-point times, the bound and the
   anatomy (rows 2a-2c);
10. check the float32 sincos identities of ``csrc/pmsm_closed_loop.cu``
    (``sincosf`` equals ``torch.sin``/``torch.cos`` of x, and of -x as
    ``-sin``/``cos``) over every float32 |x| < 2^7 on the card, and the
    start trigonometry of ``csrc/pmsm_fast.cu`` against ``torch.sin``/
    ``torch.cos`` (every float32 |x| < 2^8, seeded float32 values beyond,
    seeded float64 values, special values); then hold
    the PMSM closed-loop kernel (``csrc/pmsm_closed_loop.cu``) against
    its plain version at B = 4,096, T = 64, float32 (and one float64 case),
    tolerance 0.0: P and PI laws on saturated BRUSA and linear DEFAULT,
    deadtime 0 and 1, Euler, RK4 and Tsit5, saves every step and every 16,
    per-batch ``r_s``/``u_dc`` planes and an action band, both noise slabs,
    the linear sensorless tile at deadtime 0 and 1, the gain-scheduled
    sensorless tile, a ragged B, and the PPO actor (family 1, ActorReg<16,
    16> and ActorLaw at (24, 8)) exploring and deterministic, float32 and
    float64, saturated and linear, Euler and RK4, with and without a sensor
    slab;
11. drive the PMSM closed-loop main cases at full width (saturated BRUSA,
    B = 65,536, float32, Euler, ``tau = 1e-4``, deadtime 1): A the P law and
    B the PI law through ``env.fused_closed_loop`` over T = 2,048 (both
    pruned to the currents' columns, and again with their gains given at
    call time, which builds every column); C the
    gain-scheduled sensorless tile at ``omega_el = 1200`` with a 3 A sensor
    slab drawn on the card through ``pmsm_closed_loop`` over T = 2,048, with
    its settling error and belief RMSE; D the PI law through
    ``RolloutCollector.collect_policy_fused`` over T = 256; each with one
    launch, kernel vs plain at full size, kernel and entry-point times, the
    bound and the anatomy (rows 4a-4d);
12. hold ``fast_math=True`` in the stepper and closed-loop kernels against
    the plain versions at B = 65,536, T = 64 (Pendulum Euler and RK4 in step
    and sim-ahead modes, CartPole Tsit5, one float64 case, the PD law, ragged
    B), tolerance 0.0, then time the fast pendulum's step mode (with its
    anatomy, row 1c) and PD law (row 2d) at T = 4,096;
13. the fast pendulum kernel (``csrc/pendulum_fast.cu``, the action ring of
    ``csrc/action_ring.cuh``): kernel vs plain at 0.0 (both layouts, a
    ragged B, T = 4,099 and T = 4,100 whose horizons end inside a ring tile,
    batch-major rows no 16-byte multiple, a horizon shorter than a tile),
    the main case ``Pendulum(batch_size=65536, tau=1e-4)`` over T = 4,096
    through ``pendulum_fast_rollout`` in both layouts with one launch each,
    the batch-major slab read in place (extra memory below the slab), both
    layouts timed against the kernel, the anatomy (row 5), bench.py's gate
    (six chained rollouts within 1e-2 rad of the exact chain) and the
    sustained T = 16,384 slab;
14. the trig-free PMSM kernel (``csrc/pmsm_fast.cu``, its start and final
    angle folded in): kernel vs plain at 0.0 (B = 4,096, T = 64, DEFAULT,
    BRUSA and SEW, deadtime 0 and 1, both layouts, float64 in both
    deadtimes with its ~95 KB table, ragged B in both layouts, T odd,
    broadcast scalar leaves, start angles beyond 2^7), the main case
    saturated BRUSA B = 65,536, T = 256 through ``env.fast_rollout`` in
    both layouts with one launch each and no eager ``fast_start``,
    ``fast_final_angle`` or ``Tensor.contiguous`` (counted), the batch-major
    slab read in place (extra memory below the slab), the kernel's
    occupancy, both layouts timed against the kernel, the anatomy (row 6),
    its deviation from the exact ``env.fused_rollout`` (float32 within
    1e-4 over T = 32; over T = 256 float64 within 1e-9, and the float32 fast
    path no farther from the float64 exact path than 4 times the float32
    exact path is; a holding fleet that stays inside its current bands
    within 1e-3 in float32 over T = 256) and the kernel alone at T = 4,096;
15. the five later environments (``phase_env_kernel_vs_plain``,
    ``phase_env_golden``, ``phase_env_main``): VanDerPol, FluidTank,
    Acrobot, InductionMachine and EESM through the stepper kernel in step
    and sim-ahead modes against the plain version at B = 65,536, T = 64,
    float32, tolerance 0.0 (VanDerPol Euler and RK4 with a per-batch ``mu``
    plane from 0.5 to 20; FluidTank Euler and Heun with a quarter of the
    tanks nearly empty and no inflow, so that both clips fire; Acrobot
    Tsit5, Euler and ``fast_math=True``; the machines Euler and RK4 with
    ``u_dc = 400``, a per-batch ``r_r`` or ``l_q`` and actions beyond the
    inverter circle on part of the fleet; a float64 case, ragged B, the
    batch-major slab and FluidTank's exact-mode process-noise slab); the
    closed-loop kernel (the affine P/PD laws on Acrobot Tsit5, VanDerPol,
    the induction machine with ``u_dc`` (RK4) and the EESM with ``u_dc``
    (Euler, three actions), the (16, 16) actor on the induction machine,
    ``obs_stride = 4``); the Acrobot and FluidTank golden fixtures in float64
    through ``fused_rollout`` and ``fused_sim_ahead``, one launch each, at
    the fixture tests' rtol 1e-16; and the main cases at full width (B =
    65,536, T = 4,096, float32): ``env.fused_rollout`` of each environment
    and ``env.fused_closed_loop`` with the Acrobot PD law and the induction
    machine's PI law with ``u_dc``, each one launch, kernel vs plain at full
    size, kernel and entry-point ms and the bound;
16. the machines' drive-control tiles in the closed-loop kernel
    (``phase_foc``; ``utils/foc.py``'s FOC and sensorless FOC tiles of the
    induction machine and the EESM's current tile, functors of
    ``csrc/foc_laws.cuh``): each against the tile's plain version at
    B = 4,096 and 4,141, T = 64, tolerance 0.0 (float32 and float64, Euler
    and RK4, with and without saves, ``u_dc = 400``, the sensorless tile on
    its environment's sensor slab in both noise modes and on a slab with
    NaN flux columns, a quarter of each fleet starting cold); both FOC
    tiles on per-drive speeds and torque setpoints (the benchmark cell's
    machine and traffic), float32 and float64, ragged B, tolerance 0.0,
    before and after the setpoints change; the refusal of a tile over a
    per-batch parameter before a launch; the main cases from a cold start
    at B = 65,536 x T = 4,096, float32, Euler (rows 2g-2i: the FOC tile,
    the sensorless tile on 0.3 A sensors with its draws in fast mode, the
    EESM tile) and the benchmark cell's chunk (the per-drive sensorless
    tile at T = 2,048), one launch each through ``env.fused_closed_loop``,
    kernel vs plain at full size, kernel and entry-point ms and the bound;
    and control quality as the JAX tests assert it, at B = 4,096;
17. stochastic simulation (``phase_draws``, ``phase_noise_pendulum``,
    ``phase_noise_pmsm``, ``phase_noise_closed_loops``): the threefry
    streams of ``ops/random.py`` on the card against the CPU at B = 65,536
    (keys, ``split``/``fold_in`` chains, both modes' slab keys and uniforms
    bit for bit, normals within ``NORMAL_ULPS``, the process increments'
    std within 1% of sigma sqrt(tau)); the noisy pendulum
    (``process_noise={"omega": 0.5}``, ``observation_noise={"theta":
    0.02}``, tau = 1e-4) through ``env.fused_rollout`` in exact mode over
    T = 256 (saves every 16) and fast mode over T = 4,096 (every 64), one
    launch each, against the eager ``vmap_rollout`` from the same keys, the
    kernel 0.0 from its plain version on the same slab, the draw pre-pass,
    kernel and entry point timed; the PMSM kernel's process-noise slab
    0.0 from its plain version in float32 and float64, Euler and RK4,
    saturated and linear, deadtime 0 and 1, with and without saves (B =
    65,536, T = 64), its angle, buffers and last voltage those of the
    noiseless run; the noisy saturated BRUSA main path (T = 256, both
    modes) likewise; and the closed loops on the environment's own slabs
    (PD and PI pendulum over T = 2,048, the actor collected over T = 64,
    BRUSA PI over T = 1,024), one launch each and 0.0 from the plain loop;
18. the four exact kernels' VJPs (``phase_grad``): each entry point
    (``kernel_rollout``, ``kernel_closed_loop``, ``pmsm_kernel_rollout``,
    ``kernel_pmsm_closed_loop``) with inputs that require grad, its launch
    then the checkpointed replay, against autograd through the plain loop on
    the card, within 1e-5 (float32) and 1e-12 (float64) of the reference's
    max abs, over the CPU tests' cases at B = 4,096 (T = 16 or 13; among
    them ``RolloutVJP`` on Acrobot and ``ClosedLoopVJP`` on the induction
    machine with ``u_dc``, its constraint active on part of the fleet, and
    ``ClosedLoopVJP`` through the induction machine's FOC tile) and one
    full-width float32 case per kernel (the pendulum over T = 512 with
    ``obs_stride`` 64; BRUSA over T = 128, the holding fleet for the stepper
    and the P law for the loop); every forward 0.0 from the plain version and
    one launch, and a call without grad allocating only its outputs;
19. ``train_policy`` at B = 65,536 (``phase_train``): the noisy tracking
    pendulum of tests/test_train.py (tau = 1e-2, T = 24, 10 iterations, its
    draws fixed by the state's keys), the tracking pendulum
    with the PD law over 1,024 steps (5 iterations) and the PI law over 256
    (10), saturated BRUSA with an affine P law over 128 steps (6
    iterations, the clipped loss of benchmarks/r03/pmsm_policy_grad_device.py);
    each loss must fall and the parameters stay finite; each iteration's
    kernel forward, backward (the BRUSA law's through the adjoint kernel,
    ``BACKWARD_PATHS`` logged; the others' an eager replay) and optimizer ms
    are logged, and a ``{"grads": [...]}`` line is printed; then the adjoint
    kernel alone (``phase_adjoint``, row 4i) at the tuning cell's size,
    against its plain version and the eager replay of one backward, its
    launches counted, and the angle kernel ``csrc/pmsm_angles.cu`` (row 4j)
    at that size against the eager ``_eps_trajectory``, bit for bit;
20. the learning stack (``phase_rl``): ``train_ppo_fused`` with
    ``collector="kernel"`` at B = 65,536 and ``chunk_steps`` 64, 3
    iterations (benchmarks/r05/rl_profile_device.py's width) on the tracking
    Pendulum (tau 2e-2) and on saturated BRUSA (``control_state=["i_d",
    "i_q"]``): one launch per chunk (the counts set to 0 just before, read
    just after), the first chunk's slabs equal to ``collector="scan"``'s at
    0.0, finite metrics, each iteration's collection, transition and update
    ms; the actor's PMSM kernel at that width against its plain version, its
    time and bound (row 4e); then ``train_ppo`` at B = 4,096
    (benchmarks/r03/ppo_device.py's config, 2 iterations) and ``train_sac``
    at B = 4,096 (benchmarks/r03/sac_device.py's, 5 iterations:
    ``learning_starts`` is one iteration's 2^15 transitions, so the first
    collects with random actions and the updates start at its end), finite
    metrics and env-steps/s;
21. data generation (``phase_collect``) at the JAX package's device-script
    widths, float32: ``RolloutCollector.collect_fused`` over an ``aprbs``
    slab on the tracking Pendulum (B = 65,536, T = 2,048, one launch of the
    stepper kernel, row 1k) and on a saturated BRUSA fleet whose ``r_s``
    ``randomize_env`` draws (B = 65,536, T = 512, one launch of the PMSM
    kernel, row 3e), each equal to the eager ``collect`` in every leaf, the
    kernel with a save every step 0.0 from its plain version, and the
    kernel, entry-point, ``_assemble_batch`` and whole-call ms; the noisy
    Pendulum in fast noise mode (T = 256), ``collect_fused`` equal to
    ``collect``; ``collect_policy`` with a Gaussian-exploration PD law (T =
    256); ``adaptive_rollout`` of a Van der Pol fleet with ``mu`` over
    1..300 (B = 8,192, 8 intervals of 5e-2) against a 64-times-finer
    fixed-step Tsit5 ``fused_rollout`` (within 1e-3, no instance
    incomplete), of a mass-spring-damper fleet with ``k`` over 1..1e6
    (finite where one Euler step per tau is not) and the PMSM's own
    interval loop on a per-batch ``r_s`` fleet (B = 1,024); every line with
    the card's name and power limit;
22. estimation, planning and output-feedback control (``phase_plan``),
    float32, at the JAX package's device-script widths
    (``benchmarks/r03/mpc_fused_device.py``, ``ofc_pmsm_device.py``,
    ``estimate_pmsm_device.py``, ``foc_device.py``): ``run_mppi`` on
    saturated BRUSA (B = 512 x 64 samples x horizon 16, 32 control steps,
    the auto backend: one launch of the PMSM kernel per MPPI iteration, row
    3f) and on the tracking Pendulum (B = 4,096 x 64 x 32, 16 steps,
    ``fused=True``: one launch of the stepper kernel per iteration, row 1l),
    each 0.0 from the scan backend from the same key (which launches
    nothing), its kernel 0.0 from its plain version on one candidate sweep,
    the kernel, the candidate rollout, one iteration and its draws, reward
    and softmax timed, the bound from the bytes of the leaves it reads and
    writes; ``tests/test_mpc.py:210``'s current control at B = 512;
    ``run_ekf`` on the noisy linear drive (8 A sensors, B = 2,048 x T = 512,
    the script's 2,048 steps cut to 512, the speed pinned at 600 rad/s) and ``run_ukf`` on the noisy
    Pendulum (B = 2,048 x T = 300), each below the raw sensor's error and
    its first 8 trajectories within ``FILTER_CPU_LIMIT`` of a float64 CPU
    run; the sensorless FOC of the induction machine through
    ``run_output_feedback_controller`` (B = 4,096 from rest, 3,000 steps,
    flux within 6% and torque within 10% of their setpoints); and
    ``run_output_feedback_mppi`` on the noisy linear drive in
    ``ofc_pmsm_device.py``'s operating band (B = 512, horizon 8 x 32
    samples, 64 steps) beating its zero plan; each with its wall time, time
    per step and launches per step;
23. iLQR and system identification (``phase_ident``) at the JAX package's
    device-script widths, iteration counts cut: ``ilqr_plan`` on the
    tracking Pendulum (B = 4,096, horizon 32, five step sizes, 4
    iterations; the mean cost non-increasing and below its start, every
    action in [-1, 1], no launch; an iteration's linearization, Hessians,
    sweep and line search timed); ``fit_parameters`` on the Pendulum (8,192
    starts x 8 segments of 32 steps = 65,536 rollouts, ``spread`` 0.5, 50
    iterations; row 1m) and on the linear PMSM (``r_s``, ``l_d``, ``l_q``;
    64 starts x 16 segments of 16 steps; row 3g): one launch of the stepper
    or PMSM kernel in sim-ahead mode per iteration (and one for the final
    check), the kernel 0.0 from its plain version on one sweep, the first
    iteration's gradient within 1e-5 of autograd through the eager
    ``vmap_sim_ahead``, the kernel, the forward, the VJP replay and the
    iteration timed; ``fisher_information`` on the Pendulum (256 steps, one
    launch over 514 sensitivity copies, against a float64 CPU run) and
    ``optimize_excitation`` (48 steps x 40 iterations, eager, ``log det``
    gain above 1);
24. the batch split (``phase_shard``, ``parallel/mesh.py``) over
    ``make_batch_mesh(["cuda:0"] * 4)`` at B = 65,536, float32: the
    Pendulum ``fused_rollout`` over T = 4,096 (kernel 1, row 1n), a
    saturated BRUSA fleet with per-drive ``r_s`` over T = 256 (kernel 3,
    row 3h), the PD closed loop over T = 4,096 (kernel 2, row 2j) and the
    BRUSA PI closed loop with per-drive ``u_dc`` over T = 2,048 (kernel 4,
    row 4f): four launches per split call (the counts set to 0 just before
    it, read just after), every leaf 0.0 from the unsplit call and the final
    states 0.0 from the plain versions, the split and unsplit entry points
    timed (CUDA-event medians of 5) with their peak memory;
25. the wrappers (``phase_wrappers``) at B = 65,536: ``GymWrapper`` on the
    tracking Pendulum with references on over 1,000 steps, and the vector
    step with NEXT_STEP autoreset (``utils/episodes.py::_autoreset_step``,
    ``max_episode_steps = 200``) over 1,000 steps, ms per step with the
    renewals and resets checked; ``GymnasiumVectorEnv`` and ``MujucoWrapper``
    (B = 256, 20 steps, state on the card) where gymnasium and mujoco
    import, else a line naming what was not driven;
26. the fleet loop and the dataset path (``phase_fleet``, ``utils/fleet.py``,
    ``io/``) at B = 65,536, float32: ``FleetRunner.run`` on the Pendulum,
    16 chunks of 256 steps through kernel 1 (row 1o) into a native
    ``ShardWriter`` with the actions and a checkpoint every 8 chunks, on
    saturated BRUSA 4 chunks of 64 through kernel 3 (row 3i);
    ``run_policy`` with the PD law (4 x 1,024, kernel 2, row 2k) and the
    stateful PI law on BRUSA (4 x 512, kernel 4, row 4g); the runner over
    ``["cuda:0"] * 4``; one launch per chunk (four split), every final
    state 0.0 from direct calls and the plain versions, the shard read back
    record by record, a resume from the chunk-8 checkpoint and a retried
    chunk bit for bit with the straight run; ``DeviceLoader`` replaying the
    shard through kernel 1 (GB/s against a synchronous read and copy, the
    consumer's kernel time the prefetch hid), ``TorchShardDataset`` under
    a two-worker ``DataLoader`` and the shard CLI;
27. print the kernel table, the card's name and power limit, and last the
    result line ``{"ok": true, "device": {...}}``.

``main`` prints each phase's seconds as a ``[time] <phase> <s>`` line.

The anatomy of a redesigned kernel's case (``anatomy``): its registers,
stack and spills from the build's ``-Xptxas -v`` report; the SASS
instructions of one step, counted by ``cuobjdump -sass`` on the built
library along the shortest way through one iteration of the time loop (a
lower bound: slow paths and untaken blocks left out) and in the loop's
static body (an upper bound), with the loads and conversions in that body
(LDS, LDC, ULDC, LDG, LDGSTS, F2F); the issue time they imply, warps x steps x
instructions / (132 SMs x 4 schedulers x the maximum SM clock); the ratio
of the kernel's time to it (near 1 the kernel is issue-bound, well above 1
latency- or memory-bound); and the kernel's share of its entry point, from
CUDA events and from a ``torch.profiler`` trace where that shows device
time.  ``python3 chip_smoke.py --sass LIB.so ...`` prints the SASS part for
built libraries, for instance an earlier commit's.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"
B_MAIN, T_MAIN = 65536, 4096
#: the steps of one chunk of the benchmark cell scim-sensorless-foc-fleet-t2048
T_SCIM = 2048
T_CHECK = 64
T_PMSM, T_PMSM_LONG = 256, 4096
SOURCE = "exciting_environments_torch/csrc/stepper.cu"
REPLACES = "exciting_environments_tpu/ops/pallas/stepper.py:122"
PMSM_SOURCE = "exciting_environments_torch/csrc/pmsm_stepper.cu"
PMSM_REPLACES = "exciting_environments_tpu/ops/pallas/pmsm_stepper.py:365"
CL_SOURCE = "exciting_environments_torch/csrc/closed_loop.cu"
CL_REPLACES = "exciting_environments_tpu/ops/pallas/stepper.py:1281"
# H100 SXM published peaks (NVIDIA data sheet), used for the bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=5, warmup=1, chain=1):
    """Median time of ``fn`` over ``reps`` runs, CUDA events around each.
    With ``chain`` > 1 a run is ``chain`` calls back to back, and its time is
    divided by ``chain``: the host work of a call then overlaps the device
    work of the one before, so a short kernel's wrapper drops out."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / chain)
    return statistics.median(times)


def max_abs(xs, ys):
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(xs, ys))


def extra_memory(fn):
    """The device memory that ``fn`` allocates at its peak beyond what was
    allocated before it, in bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def entry(name, launches, err, ms, plain_ms, bound_ms, bound_by, source, replaces):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def roofline(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel anatomy: registers, SASS per step, issue time, profiler share
# ---------------------------------------------------------------------------

SMS, SCHEDULERS = 132, 4  # H100 SXM: 132 SMs, 4 warp schedulers each
STEPPER_TILE_ROWS = 16  # action rows per tile of csrc/stepper.cu's ring, float32 with one action
#: action rows per ring tile of the kernels that stream their slab through csrc/action_ring.cuh (float32, one
#: action); a build without the ring (no cp.async, LDGSTS) is counted untiled
TILE_ROWS = {"stepper": STEPPER_TILE_ROWS, "pendulum_fast": 32}
_SASS = {}


def _tool(name):
    """A CUDA binary utility: on PATH, in the toolkit, or Triton's copy."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which(name)
    if found:
        return found
    for base in [Path(CUDA_HOME or "/usr/local/cuda") / "bin"] + [
            Path(p) / "triton" / "backends" / "nvidia" / "bin" for p in sys.path if p]:
        if (base / name).is_file():
            return str(base / name)
    return None


def _demangle(names):
    for tool in ("c++filt", "cu++filt"):
        path = _tool(tool)
        if path:
            out = subprocess.run([path], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
            if len(out) == len(names):
                return dict(zip(names, out))
    return {n: n for n in names}


def _sass_functions(lib):
    """{demangled kernel name: [(address, instruction text)]} of a library."""
    if lib in _SASS:
        return _SASS[lib]
    tool = _tool("cuobjdump")
    funcs = {}
    if tool:
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
        current = None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                current = m.group(1)
                funcs[current] = []
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m and current is not None:
                funcs[current].append((int(m.group(1), 16), m.group(2)))
        names = _demangle(list(funcs))
        funcs = {names[k]: v for k, v in funcs.items()}
    _SASS[lib] = funcs
    return funcs


def _loops(code):
    """Loops of one kernel's SASS as (start, end) address spans of the
    backward branches before the last unconditional EXIT (out-of-line slow
    paths after it are left out), each with its own static body: the
    instructions of the span not inside a nested loop."""
    exits = [a for a, ins in code if ins == "EXIT"]
    last_exit = max(exits, default=max(a for a, _ in code))
    spans = []
    for addr, ins in code:
        m = re.search(r"\bBRA(?:\.[A-Z]+)*\s[^;]*?0x([0-9a-f]+)\s*$", ins)
        if m and int(m.group(1), 16) < addr < last_exit:
            spans.append((int(m.group(1), 16), addr))
    spans = sorted(set(spans))
    inside = lambda a, s: s[0] <= a <= s[1]
    loops = []
    for s in spans:
        nested = [t for t in spans if t != s and s[0] <= t[0] and t[1] <= s[1]]
        body = [ins for a, ins in code if inside(a, s) and not any(inside(a, t) for t in nested)]
        loops.append({"span": s, "own": len(body), "body": body,
                      "ops": {_opcode(ins) for ins in body if not ins.startswith("@!PT")}})
    return loops


def loop_loads(lib, kernel_re):
    """{opcode: count} of LOOP_OPCODES (by the opcode's first word) in the
    static body of the kernel's time loop, the loop with the largest own
    body: which loads and conversions one pass of it issues at most."""
    pattern = kernel_pattern(lib, kernel_re)
    funcs = [c for n, c in _sass_functions(lib).items() if re.search(pattern, n)]
    loops = _loops(funcs[0]) if len(funcs) == 1 else []
    if not loops:
        return None
    body = max(loops, key=lambda lp: lp["own"])["body"]
    ops = [_opcode(ins).split(".")[0] for ins in body if not ins.startswith("@!PT")]
    return {op: ops.count(op) for op in LOOP_OPCODES if op in ops}


def _opcode(ins):
    """The opcode of a SASS instruction, its predicate stripped."""
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split(" ")[0]


def hot_path(code, span, via=()):
    """The fewest SASS instructions from a loop's head to its back edge,
    passing through an instruction (its predicate stripped) that matches
    each regex of ``via`` in turn: one iteration along its shortest way, with every
    branch to a slow path, an inner loop's repeat or a rare block not taken.
    A lower bound of the instructions one iteration issues."""
    from collections import deque

    start, end = span
    idx = {a: i for i, (a, _) in enumerate(code)}
    opcode = _opcode

    def successors(i):
        addr, ins = code[i]
        op = opcode(ins)
        predicated = ins.startswith("@") and not ins.startswith("@PT")
        nxt = [code[i + 1][0]] if i + 1 < len(code) else []
        if op in ("EXIT", "RET") or op.startswith(("EXIT.", "RET.")):
            return nxt if predicated else []
        m = re.search(r"0x([0-9a-f]+)\s*$", ins)
        if op.startswith("BRA") and m:
            conditional = predicated or re.search(r"\b!?U?P[0-6]\b", ins.split(op, 1)[1])
            return ([int(m.group(1), 16)] + (nxt if conditional else []))
        return nxt

    n_via = len(via)
    bare = lambda ins: re.sub(r"^@!?U?P\w+\s+", "", ins)
    first = (start, 1 if n_via and re.search(via[0], bare(code[idx[start]][1])) else 0)
    dist = {first: 1}
    queue = deque([first])
    while queue:
        addr, stage = queue.popleft()
        if addr == end and stage == n_via:
            return dist[(addr, stage)]
        if addr == end:
            continue
        for nxt in successors(idx[addr]):
            if not start <= nxt <= end or nxt not in idx:
                continue
            ins = code[idx[nxt]][1]
            st = stage + (1 if stage < n_via and not ins.startswith("@!PT") and re.search(via[stage], bare(ins))
                          else 0)
            if (nxt, st) not in dist:
                dist[(nxt, st)] = dist[(addr, stage)] + 1
                queue.append((nxt, st))
    return None


def sass_step_count(lib, kernel_re, via=(), tile_rows=None):
    """(kernel name, SASS instructions per step on the hot path, static
    instructions per step).  The time loop is the loop with the largest own
    body; per step is its hot path (:func:`hot_path`, through ``via`` where
    a case's work sits behind a branch the shortest way would skip), and
    its own body counts every instruction once, slow paths and untaken
    blocks included: an upper bound.  In the tiled stepper (``tile_rows``
    action rows per tile, one step per row at hold 1) the step loop sits in
    a row loop in a tile loop (it waits on the ring: BAR): per step is the
    row loop's hot path through an action read (LDS) plus the tile loop's
    extra path, through its cp.async (LDGSTS), over ``tile_rows``."""
    kernel_re = kernel_pattern(lib, kernel_re)
    funcs = {n: c for n, c in _sass_functions(lib).items() if re.search(kernel_re, n)}
    if len(funcs) != 1:
        return None, None, None
    (name, code), = funcs.items()
    loops = _loops(code)
    if not loops:
        return name, None, None
    if tile_rows is None:
        step = max(loops, key=lambda lp: lp["own"])
        return name, hot_path(code, step["span"], via), step["own"]
    # the tile loop waits on the ring (BAR); inside it the row loop, the
    # outermost loop around the step loop, reads an action row (LDS)
    within = lambda a, b: b["span"][0] <= a["span"][0] and a["span"][1] <= b["span"][1]
    tiles = [lp for lp in loops if any(o.startswith("BAR") for o in lp["ops"])]
    step = max(loops, key=lambda lp: lp["own"])
    if len(tiles) != 1 or not within(step, tiles[0]):
        return name, None, None
    tile = tiles[0]
    if step is tile:
        # the tile's rows unrolled in its body: per step is a tile's pass over tile_rows
        hot_tile = hot_path(code, tile["span"], ("^LDGSTS", "^LDS") + tuple(via))
        return name, (hot_tile / tile_rows if hot_tile else None), tile["own"] / tile_rows
    row = max((lp for lp in loops if lp is not tile and within(step, lp) and within(lp, tile)),
              key=lambda lp: lp["span"][1] - lp["span"][0])
    static = sum(lp["own"] for lp in loops if within(lp, row)) + tile["own"] / tile_rows
    hot_row = hot_path(code, row["span"], ("^LDS",) + tuple(via))
    hot_tile = hot_path(code, tile["span"], ("^LDGSTS", "^LDS") + tuple(via))
    return name, (hot_row + (hot_tile - hot_row) / tile_rows if hot_row and hot_tile else None), static


def ptxas_resources(lib, kernel_re):
    """(registers, stack frame bytes, spill store bytes) of the kernel whose
    demangled name matches, from the build's ``-Xptxas -v`` report."""
    lines = Path(lib).with_suffix(".log").read_text().splitlines()
    regs, frames, current = {}, {}, None
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        f = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", lines[i + 1]) if m and i + 1 < len(
            lines) else None
        if f:
            frames[m.group(1)] = (int(f.group(1)), int(f.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            regs[current] = int(m.group(1))
    names = _demangle(list(regs))
    kernel_re = kernel_pattern(lib, kernel_re)
    hits = [(r,) + frames.get(n, (None, None)) for n, r in regs.items() if re.search(kernel_re, names[n])]
    return hits[0] if len(hits) == 1 else (None, None, None)


def sm_clock_mhz():
    """(current, maximum) SM clock in MHz, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    cur, mx = (float(v) for v in out[0].split(","))
    return cur, mx


def profile_share(entry_fn, kernel_substring):
    """torch.profiler over one call of an entry point: (the kernel's device
    time, the entry point's wall time, the device's busy time), in ms.  None
    where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    entry_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        entry_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernel_us = [], 0.0
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            spans.append((ev.time_range.start, ev.time_range.end))
            if kernel_substring in ev.name:
                kernel_us += ev.time_range.elapsed_us()
    if not spans:
        return None, wall_ms, None
    busy, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return kernel_us / 1e3, wall_ms, busy / 1e3


def anatomy(row, lib, kernel_re, ms, entry_ms, batch, n_steps, entry_fn, kernel_substring, vias=((),),
            tile_rows=None):
    """Step 0 of a kernel redesign for one case: registers and spills, SASS
    instructions per step of the time loop (hot path and static body), the
    issue time they imply (warps x steps x instructions / (SMs x schedulers
    x the maximum SM clock)), the ratio of the kernel's time to it, and the
    kernel's share of its entry point: from a torch.profiler trace where it
    shows device time, and from the CUDA-event times ``ms``/``entry_ms``."""
    regs, stack, spill = ptxas_resources(lib, kernel_re)
    if tile_rows is None:
        pattern = kernel_pattern(lib, kernel_re)
        code = next((c for n, c in _sass_functions(lib).items() if re.search(pattern, n)), [])
        tile_rows = tile_rows_of(Path(lib).stem.rsplit("_", 1)[0], code)
    for via in vias:  # the first way through the case's work that the SASS has
        name, hot, static = sass_step_count(lib, kernel_re, via, tile_rows)
        if hot:
            break
    cur, mx = sm_clock_mhz()
    warps = -(-batch // 32)
    issue = lambda n: warps * n_steps * n / (SMS * SCHEDULERS * mx * 1e6) * 1e3 if n else None
    issue_ms, issue_static_ms = issue(hot), issue(static)
    k_ms, wall_ms, busy_ms = profile_share(entry_fn, kernel_substring)
    ratio = ms / issue_ms if issue_ms else None
    traced = (f"kernel {k_ms!r} ms of the entry point's {wall_ms!r} ms ({k_ms / wall_ms:.1%}), device busy "
              f"{busy_ms!r} ms" if k_ms else "no device time in the trace")
    log(f"[anatomy] {row}: {name}: {regs} registers, {stack} B stack, {spill} B spill; SASS per step "
        f"{hot!r} on the hot path{' (tiled)' if tile_rows else ''}, {static} static, time-loop body loads "
        f"{loop_loads(lib, kernel_re)}; issue time {issue_ms!r} ms (static {issue_static_ms!r}) at "
        f"{mx:.0f} MHz (now {cur:.0f}); kernel {ms!r} ms = {ratio!r} x issue; kernel share of the entry "
        f"point by CUDA events {ms!r} / {entry_ms!r} ms = {ms / entry_ms:.1%}; profiler: {traced}")


#: 16-byte shared-memory loads of a step of the staged per-drive scheduled
#: tile (row 4h): the magnetics gather's two a corner and the staged
#: schedule's three, so its hot path passes the staged gather, not the
#: device-memory fallback beside it
STAGED_STEP_LDS = 4 * (2 + 3)
#: the redesigned kernels' main cases: (rows, library, demangled-name regex
#: or alternatives (this tree's name first, then an earlier tree's), the hot
#: path's via alternatives, tried in turn).  Rows sharing an instantiation
#: share an entry.  Step mode passes through the angle wrap (its 2 pi, or
#: the fast wrap's 1 / (2 pi)), sim-ahead RK4 also reads the next action row
#: (a second LDS in the tiled stepper), the scheduled tile gathers its maps
#: (16-byte read-only loads, or the parent's scalar ones; per drive, the
#: staged 16-byte shared-memory loads first), the PMSM stepper
#: passes through its constraint's sector test (2/3 pi)
SASS_CASES = [
    ("1a", "stepper", r"stepper_kernel<float, PendulumEnv<ExactMath>, 1[,>]", [(r"6\.2831854",), ()]),
    ("1b", "stepper", r"stepper_kernel<float, PendulumEnv<ExactMath>, 4[,>]", [(r"^LDS",), ()]),
    ("1c", "stepper", r"stepper_kernel<float, PendulumEnv<FastMath>, 1[,>]", [(r"0\.1591549",), ()]),
    ("2a/2b", "closed_loop", (r"closed_loop_kernel<float, PendulumEnv<ExactMath>, 1, AffineReg<3>\s?>",
                              r"closed_loop_kernel<float, PendulumEnv<ExactMath>, 1, AffineLaw>"),
     [(r"6\.2831854",), ()]),
    ("2c", "closed_loop", (r"closed_loop_kernel<float, PendulumEnv<ExactMath>, 1, ActorReg<16, 16>\s?>",
                           r"closed_loop_kernel<float, PendulumEnv<ExactMath>, 1, ActorLaw>"), [()]),
    ("2d", "closed_loop", (r"closed_loop_kernel<float, PendulumEnv<FastMath>, 1, AffineReg<3>\s?>",
                           r"closed_loop_kernel<float, PendulumEnv<FastMath>, 1, AffineLaw>"),
     [(r"0\.1591549",), ()]),
    ("3a", "pmsm_stepper", r"pmsm_kernel<float, 1, true>", [(r"2\.094395",), (r"6\.2831854",), ()]),
    ("3b", "pmsm_stepper", r"pmsm_kernel<float, 4, true>", [(r"2\.094395",), (r"6\.2831854",), ()]),
    ("4a/4b/4d", "pmsm_closed_loop", (r"pmsm_closed_loop_kernel<float, 1, true, AffineCurrentsReg>",
                                      r"pmsm_closed_loop_kernel<float, 1, true, AffineAdapter>"), [()]),
    ("4a-all/4b-all", "pmsm_closed_loop", r"pmsm_closed_loop_kernel<float, 1, true, AffineAdapter>", [()]),
    ("4c", "pmsm_closed_loop", r"pmsm_closed_loop_kernel<float, 1, true, ScheduledLaw>",
     [(r"^LDG\.E\.128\.CONSTANT",), (r"^LDG\.E\.CONSTANT",)]),
    ("4h", "pmsm_closed_loop", r"pmsm_closed_loop_kernel<float, 1, true, ScheduledDriveLaw>",
     [(r"^LDS\.128",) * STAGED_STEP_LDS, (r"^LDG\.E\.128\.CONSTANT",), (r"^LDG\.E\.CONSTANT",)]),
    ("5", "pendulum_fast", r"pendulum_fast_kernel", [(r"0\.1591549",), ()]),
    ("6", "pmsm_fast", r"pmsm_fast_kernel<float, true, 1>", [()]),
]
#: the loads and conversions whose count in a time loop's body the anatomy reports
LOOP_OPCODES = ("LDS", "LDC", "ULDC", "LDG", "LDGSTS", "F2F")


def sass_case(row):
    """(library name, kernel regex, vias) of the SASS_CASES row that covers
    ``row``."""
    return next((name, kernel_re, vias) for r, name, kernel_re, vias in SASS_CASES if row in r.split("/"))


def kernel_pattern(lib, kernel_re):
    """The first of a case's regexes (one, or alternatives for the kernel's
    name in this tree and in an earlier one) that matches exactly one kernel
    of the library."""
    alts = (kernel_re,) if isinstance(kernel_re, str) else tuple(kernel_re)
    names = list(_sass_functions(lib))
    return next((alt for alt in alts if sum(bool(re.search(alt, n)) for n in names) == 1), alts[0])


def tile_rows_of(kind, code):
    """Action rows per ring tile of a kernel (its library's kind and SASS)
    that streams its slab through the ring (cp.async, LDGSTS), else None."""
    if kind not in TILE_ROWS or not any(ins.split(" ")[0].startswith("LDGSTS") for _, ins in code):
        return None
    return TILE_ROWS[kind]


def sass_report(libraries):
    """The SASS anatomy of the main cases in built kernel libraries (this
    tree's, or an earlier commit's): registers, stack and spills, and the
    instructions per step on the hot path and in the static body.  A
    library with the action ring (cp.async, LDGSTS) is counted as tiled."""
    for lib in map(Path, libraries):
        kind = lib.stem.rsplit("_", 1)[0]
        for row, name, kernel_re, vias in SASS_CASES:
            if name != kind:
                continue
            pattern = kernel_pattern(lib, kernel_re)
            code = next((c for n, c in _sass_functions(lib).items() if re.search(pattern, n)), [])
            tile_rows = tile_rows_of(kind, code)
            for via in vias:
                found, hot, static = sass_step_count(lib, kernel_re, via, tile_rows)
                if hot:
                    break
            regs, stack, spill = ptxas_resources(lib, kernel_re)
            log(f"[sass] {lib.name} {row}: {found}: {regs} registers, {stack} B stack, {spill} B spill; "
                f"per step {hot!r} on the hot path{' (tiled)' if tile_rows else ''}, {static} static; "
                f"time-loop body loads {loop_loads(lib, kernel_re)}")
    return 0


def phase_trig():
    """The float32 trigonometric identities of csrc/pmsm_closed_loop.cu, over
    every float32 |x| < 2^7 on the card; then the start trigonometry of
    csrc/pmsm_fast.cu (the literal sinf/cosf, sin/cos in float64) against
    torch.sin/torch.cos: every float32 |x| < 2^8, 2^26
    seeded float32 values beyond, and in float64 2^26 seeded values over the
    range the start meets (the wrapped angle plus 1.5 tau omega, |x| < 8)
    and 2^24 beyond, with the special values.  Any mismatch fails."""
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
    from exciting_environments_torch.ops.kernels import pmsm_fast_kernel as PMK

    t0 = time.perf_counter()
    counts = PCL.sincos_mismatches()
    torch.cuda.synchronize()
    log(f"[trig] sincosf against torch.sin/cos of x and -x, every float32 |x| < 2^7: {counts} "
        f"in {time.perf_counter() - t0:.2f} s")
    if any(v for k, v in counts.items() if k != "inputs"):
        raise AssertionError(f"the kernel's sincos identities fail on this card: {counts}")

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    special = [0.0, -0.0, float("inf"), -float("inf"), float("nan"), 128.0, -128.0, np.pi, -np.pi]
    total = {}

    def tally(name, x):
        got = PMK.start_trig_mismatches(x)
        acc = total.setdefault(name, {k: 0 for k in got})
        for k, v in got.items():
            acc[k] += v

    end, chunk = int(np.array(2.0 ** 8, dtype=np.float32).view(np.int32)), 1 << 27
    for start in range(0, end, chunk):
        pattern = torch.arange(start, min(start + chunk, end), dtype=torch.int32, device=DEVICE).view(torch.float32)
        tally("float32 |x| < 2^8, every value", pattern)
        tally("float32 |x| < 2^8, every value", -pattern)
    wide = lambda dtype, n, lo, hi: (torch.sign(torch.rand(n, generator=gen, device=DEVICE, dtype=torch.float64) - 0.5)
                                     * torch.exp2(lo + (hi - lo) * torch.rand(n, generator=gen, device=DEVICE,
                                                                              dtype=torch.float64))).to(dtype)
    tally("float32 2^7 <= |x| < 2^30, seeded", wide(torch.float32, 1 << 26, 7.0, 30.0))
    tally("float32 special", torch.tensor(special, device=DEVICE, dtype=torch.float32))
    tally("float64 |x| < 8, seeded", (torch.rand(1 << 26, generator=gen, device=DEVICE, dtype=torch.float64) * 16 - 8))
    tally("float64 2^3 <= |x| < 2^30, seeded", wide(torch.float64, 1 << 24, 3.0, 30.0))
    tally("float64 special", torch.tensor(special, device=DEVICE, dtype=torch.float64))
    torch.cuda.synchronize()
    log(f"[trig] pmsm_fast start_sincos against torch.sin/cos: {total} in {time.perf_counter() - t0:.2f} s")
    if any(v for counts in total.values() for k, v in counts.items() if k != "inputs"):
        raise AssertionError(f"the fast PMSM kernel's start trigonometry differs from PyTorch's on this card: {total}")


def ode_ops(env):
    """Operations of one vector-field evaluation, counted from
    csrc/classic_envs.cuh: each add, multiply, divide, reciprocal, negation,
    compare, clamp and each sin/cos/sign/sqrt call as one; with fast_math
    each poly_sin is 16 operations, each wrap_angle_fast 5, the cosine's
    shift 1 and fast_sign 3.  Ids: 0 Pendulum, 1 MassSpringDamper, 2
    CartPole, 3 VanDerPol, 4 FluidTank, 5 Acrobot (one sine and three
    cosine calls), 6 InductionMachine, 7 EESM."""
    if getattr(env, "fast_math", False):
        return {0: 3 + 21, 1: 5, 2: 28 + 21 + 22 + 3, 3: 6, 4: 6, 5: 43 + 21 + 3 * 22, 6: 26,
                7: 22}[env._kernel_env_id]
    return {0: 4, 1: 5, 2: 31, 3: 6, 4: 6, 5: 47, 6: 26, 7: 22}[env._kernel_env_id]


def constraint_ops(env):
    """Operations of the action constraint per denormalized action row, and
    of the post-step clip (FluidTank's clamp) per step."""
    from exciting_environments_torch.ops.kernels.stepper import kernel_svm_limit

    return (SVM_OPS if kernel_svm_limit(env) else 0), (TANK_CLIP_OPS if env._kernel_env_id == 4 else 0)


def ops_per_step(env, solver, sim_ahead):
    """Arithmetic operations of one step of one instance, counting each add,
    multiply, divide, compare and each sin/cos/fmod call as one (the wrap,
    exact or fast, as 5)."""
    from exciting_environments_torch.ops.kernels.stepper import _stage_rows

    a_rows, b = _stage_rows(solver)
    n = len(env._ode_state_fields)
    comb = lambda coeffs: sum(2 - (c == 1.0) for c in coeffs if c != 0.0) + 1 if any(coeffs) else 0
    svm, clip = constraint_ops(env)
    per_step = (4 * env.action_dim + svm) * (2 if sim_ahead else 1)  # in-kernel denormalization and constraint
    per_step += len(b) * ode_ops(env) + n * (sum(comb(r) for r in a_rows) + comb(b))
    if not sim_ahead:
        per_step += 5 * len(env._angle_fields) + clip  # wrap: add, fmod, compare, add, sub
    return per_step


def bound(env, solver, batch, n_steps, n_rows, n_saves, sim_ahead, itemsize=4):
    """Least time for the work: bytes moved once (actions, initial and final
    state, saves) over the memory rate, or operations over the float32 rate."""
    n = len(env._ode_state_fields)
    nbytes = itemsize * (n_rows * batch * env.action_dim + 2 * n * batch + n_saves * n * batch)
    ops = ops_per_step(env, solver, sim_ahead) * batch * n_steps
    return roofline(nbytes, ops)


def make_env(cls, batch, dtype=torch.float32, **kwargs):
    return cls(batch_size=batch, device=DEVICE, dtype=dtype, **kwargs)


def random_state(env, gen):
    y0 = tuple(
        (torch.rand(env.batch_size, generator=gen, device=DEVICE, dtype=torch.float64) * 2 - 1).to(env.dtype)
        for _ in env._ode_state_fields
    )
    return y0


def random_actions(env, n_rows, gen, lim=0.9):
    u = torch.rand((n_rows, env.batch_size, env.action_dim), generator=gen, device=DEVICE, dtype=torch.float64)
    return ((u * 2 - 1) * lim).to(env.dtype)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build(K):
    t0 = time.perf_counter()
    paths = K.build_all()
    K.KERNEL.lib()
    log(f"[build] {', '.join(p.name for p in paths.values())} ready in {time.perf_counter() - t0:.1f} s")
    if K.BUILD_TIMES:
        times = {k: v for k, v in K.BUILD_TIMES.items() if k != "total"}
        longest = max(times, key=times.get)
        log(f"[build] whole build {K.BUILD_TIMES['total']:.1f} s ({len(times)} nvcc processes, one per source "
            f"and one link per library, the sources all started together); longest single nvcc: {longest} "
            f"{times[longest]:.1f} s")
        log("[build] nvcc seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(times.items(),
                                                                                  key=lambda kv: -kv[1])))
    for path in paths.values():
        report = path.with_suffix(".log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        smem = sorted({int(b) for b in re.findall(r"(\d+) bytes smem", report)})
        frames = [(name, int(stack), int(spill)) for name, stack, spill in re.findall(
            r"Function properties for (\S*_kernel\S*)\s+(\d+) bytes stack frame, (\d+) bytes spill stores", report)]
        log(f"[build] {path.stem.rsplit('_', 1)[0]}: {len(regs)} kernels, registers per thread "
            f"{min(regs, default=0)}..{max(regs, default=0)}, static shared memory bytes {smem or [0]}, "
            f"non-zero stack frames: {sum(s > 0 for _, s, _ in frames)}")
        # by policy family where the kernel has one (closed_loop.cu), else all together
        families = ("AffineReg", "AffineGeneric", "ActorReg", "AffineLaw", "ActorLaw", "AffineAdapter",
                    "SensorlessLaw", "ScheduledLaw", "SensorlessFocTile", "FocTile", "EesmCurrentTile")
        for family in sorted({next((f for f in families if f in n), "all") for n, _, _ in frames}):
            group = [(s, sp) for n, s, sp in frames if family == "all" or family in n]
            log(f"[build]   {family}: stack frames {min(s for s, _ in group)}..{max(s for s, _ in group)} bytes, "
                f"{sum(sp > 0 for _, sp in group)} of {len(group)} kernels spill")


def phase_kernel_vs_plain(ex, K):
    """Kernel against its plain version, f32, B = 65,536, T = 64."""
    from exciting_environments_torch.utils import MinMaxNormalization

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    B, T = B_MAIN, T_CHECK
    lengths = (1.0 + torch.rand(B, generator=gen, device=DEVICE)).to(torch.float32)
    masses = (0.5 + torch.rand(B, generator=gen, device=DEVICE)).to(torch.float32)
    torque_max = (10.0 + 10 * torch.rand(B, generator=gen, device=DEVICE)).to(torch.float32)
    # (label, env, rollout kwargs).  The tolerance is 0.0 for every case: the
    # kernel performs the plain version's operations in the same order and
    # precision (built with --fmad=false, PyTorch's CUDA division rule).
    cases = [
        ("pendulum euler", make_env(ex.Pendulum, B), {}),
        ("pendulum rk4", make_env(ex.Pendulum, B, solver="rk4"), {}),
        ("pendulum tsit5", make_env(ex.Pendulum, B, solver="tsit5"), {}),
        ("mass_spring_damper rk4", make_env(ex.MassSpringDamper, B, solver="rk4"), {}),
        ("cart_pole tsit5", make_env(ex.CartPole, B, solver="tsit5"), {}),
        ("pendulum per-batch l, m, torque max", make_env(
            ex.Pendulum, B, static_params={"l": lengths, "m": masses, "g": 9.81},
            action_normalizations={"torque": MinMaxNormalization(min=-20, max=torque_max)}), {}),
        ("pendulum noise slab", make_env(ex.Pendulum, B), {"noise": True}),
        ("pendulum rk4 obs_stride=4", make_env(ex.Pendulum, B, solver="rk4"), {"obs_stride": 4}),
        ("pendulum rk4 sim-ahead ratio 1", make_env(ex.Pendulum, B, solver="rk4"),
         {"sim_ahead": True, "hold": 1, "obs_stride": 8}),
        ("pendulum rk4 sim-ahead ratio 2", make_env(ex.Pendulum, B, solver="rk4"),
         {"sim_ahead": True, "hold": 2, "obs_stride": 8}),
        ("cart_pole euler ragged B=1000", make_env(ex.CartPole, 1000), {}),
        # the action ring: a batch-major slab read in place, use_next across
        # tile boundaries, a horizon that ends inside a tile, and slabs whose
        # rows are not 16-byte multiples (element-wise copies)
        ("pendulum euler batch-major slab", make_env(ex.Pendulum, B), {"batch_major": True}),
        ("pendulum rk4 sim-ahead ratio 2 batch-major, next rows across tiles", make_env(ex.Pendulum, B, solver="rk4"),
         {"sim_ahead": True, "hold": 2, "obs_stride": 8, "batch_major": True}),
        ("pendulum rk4 sim-ahead ratio 1, T=50 (not a multiple of the tile)", make_env(ex.Pendulum, B, solver="rk4"),
         {"sim_ahead": True, "obs_stride": 5, "steps": 50}),
        ("cart_pole tsit5 ragged B=1001 time-major, element-wise copies", make_env(ex.CartPole, 1001, solver="tsit5"),
         {}),
        ("pendulum euler ragged B=1001 batch-major, T=50, element-wise copies", make_env(ex.Pendulum, 1001),
         {"batch_major": True, "steps": 50}),
        ("pendulum rk4 float64 batch-major sim-ahead ratio 2", make_env(ex.Pendulum, 4096 + 77, torch.float64,
                                                                         solver="rk4"),
         {"sim_ahead": True, "hold": 2, "obs_stride": 4, "batch_major": True}),
    ]
    failures = []
    for label, env, kw in cases:
        kw = dict(kw)
        hold = kw.get("hold", 1)
        steps = kw.pop("steps", T)
        batch_major = kw.pop("batch_major", False)
        y0 = random_state(env, gen)
        acts = random_actions(env, steps // hold, gen)
        if kw.pop("noise", False):
            kw["noise_tm"] = (0.01 * torch.randn((T, env.batch_size, 2), generator=gen, device=DEVICE)).to(env.dtype)
            kw["noise_idx"] = (0, 1)
        tau = env.tau
        slab = acts.transpose(0, 1).contiguous() if batch_major else acts
        yk, tk = K.kernel_rollout(env, y0, slab, tau=tau, batch_major=batch_major, **kw)
        yp, tp = K.plain_rollout(env, y0, acts, tau=tau, **kw)
        torch.cuda.synchronize()
        err = max_abs(yk, yp)
        if tk is not None:
            err = max(err, max_abs(tk, tp))
        finite = all(bool(torch.isfinite(y).all()) for y in yk)
        ok = finite and err == 0.0
        log(f"[kernel vs plain] {label}: max abs deviation {err!r} (tolerance 0.0) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")


def phase_golden(ex, K):
    """Pendulum golden fixture, float64, B = 1, 10,000 steps, one launch."""
    from exciting_environments_torch.utils import load_sim_properties_from_json

    data = ROOT / "tests" / "envs" / "pendulum" / "data"
    params, action_norms, physical_norms, tau = load_sim_properties_from_json(data / "sim_properties.json")
    env = ex.Pendulum(batch_size=1, tau=tau, solver="euler", static_params=params,
                      physical_normalizations=physical_norms, action_normalizations=action_norms,
                      device=DEVICE, dtype=torch.float64)
    stored = torch.as_tensor(np.load(data / "observations.npy"), device=DEVICE)
    actions = torch.as_tensor(np.load(data / "actions.npy"), device=DEVICE)
    n = actions.shape[0]
    state = env.generate_state_from_observation(stored[0][None], env.env_properties)
    y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
    _, traj = K.kernel_rollout(env, y0, actions[:, None, :], tau=env.tau, obs_stride=1)
    traj_state = ex.Pendulum.PhysicalState(**dict(zip(env._ode_state_fields, traj)))
    obs = env.generate_observation(
        env.State(physical_state=traj_state, PRNGKey=None, additions=None,
                  reference=env._nan_reference((n, 1))), env.env_properties)[:, 0]
    generated = torch.cat([stored[:1], obs], dim=0)
    dev = float((generated - stored).abs().max())
    ok = bool(torch.allclose(generated, stored, 1e-16))
    log(f"[golden] pendulum fixture, {n} float64 steps in one launch: max abs deviation {dev!r}, "
        f"allclose(rtol=1e-16) {ok}")
    if not ok:
        raise AssertionError("golden pendulum replay through the kernel deviates from the fixture")


def phase_main(ex, K):
    """Main path at full size; returns the kernel table entries."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    B, T = B_MAIN, T_MAIN
    env = ex.Pendulum(batch_size=B, tau=1e-4, device=DEVICE)
    env_sa = ex.Pendulum(batch_size=B, tau=1e-4, solver="rk4", device=DEVICE)
    _, state = env.vmap_reset(rng=gen)
    actions_tm = random_actions(env, T, gen)
    actions_bm = actions_tm.transpose(0, 1).contiguous()
    sa_stride = 64
    log(f"[main] Pendulum B={B} T={T} float32: actions {actions_tm.numel() * 4 / 1e9:.3f} GB per layout")

    K.KERNEL.reset_counts()
    obs_tm, last_tm = env.fused_rollout(state, actions_tm, time_major=True, strict=True)
    obs_bm, last_bm = env.fused_rollout(state, actions_bm, strict=True)
    obs_sa, last_sa = env_sa.fused_sim_ahead(state, actions_bm, env_sa.tau, env_sa.tau,
                                             obs_stride=sa_stride, strict=True)
    torch.cuda.synchronize()
    launches = dict(K.KERNEL.launches)
    log(f"[main] launches during the main path: {launches}")
    if launches["step"] < 1 or launches["sim_ahead"] < 1:
        raise AssertionError(f"the main path did not go through the kernel: {launches}")
    if tuple(obs_tm.shape) != (B, 2) or tuple(obs_sa.shape) != (B, 1 + T // sa_stride, 2):
        raise AssertionError(f"unexpected shapes {tuple(obs_tm.shape)}, {tuple(obs_sa.shape)}")
    if not (torch.isfinite(obs_tm).all() and torch.isfinite(obs_sa).all()):
        raise AssertionError("non-finite observations on the main path")
    if not torch.equal(obs_tm, obs_bm):
        raise AssertionError("time-major and batch-major layouts disagree")
    if float(obs_tm[:, 0].abs().max()) > 1.0:
        raise AssertionError("wrapped angle left the normalized band")

    y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
    step_kernel = lambda: K.kernel_rollout(env, y0, actions_tm, tau=env.tau)
    sa_kernel = lambda: K.kernel_rollout(env_sa, y0, actions_tm, tau=env_sa.tau, sim_ahead=True,
                                         obs_stride=sa_stride)
    # one untimed run each for the comparison, then the timings
    yk, _ = step_kernel()
    t0 = time.perf_counter()
    yp, _ = K.plain_rollout(env, y0, actions_tm, tau=env.tau)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err_step = max_abs(yk, yp)
    yks, tks = sa_kernel()
    t0 = time.perf_counter()
    yps, tps = K.plain_rollout(env_sa, y0, actions_tm, tau=env_sa.tau, sim_ahead=True, obs_stride=sa_stride)
    torch.cuda.synchronize()
    plain_sa_ms = (time.perf_counter() - t0) * 1e3
    err_sa = max(max_abs(yks, yps), max_abs(tks, tps))
    log(f"[main] kernel vs plain at full size: step max abs {err_step!r}, sim-ahead max abs {err_sa!r}")
    if err_step != 0.0 or err_sa != 0.0:
        raise AssertionError("kernel disagrees with its plain version at the main size")

    # the kernel reads a batch-major slab in place: the same results, and no
    # transposed copy (the entry point's extra memory stays below the slab's)
    bm_kernel = lambda: K.kernel_rollout(env, y0, actions_bm, tau=env.tau, batch_major=True)
    err_bm = max_abs(bm_kernel()[0], yk)
    slab_bytes = actions_tm.numel() * actions_tm.element_size()
    extra = extra_memory(lambda: env.fused_rollout(state, actions_bm, strict=True))
    log(f"[main] batch-major slab read in place: kernel vs time-major max abs {err_bm!r}; env.fused_rollout "
        f"batch-major allocated at most {extra} B beyond its inputs (slab {slab_bytes} B)")
    if err_bm != 0.0 or extra >= slab_bytes:
        raise AssertionError("the batch-major slab was copied, or read differently from the time-major one")

    ms = time_ms(step_kernel)
    bm_ms = time_ms(bm_kernel)
    sa_ms = time_ms(sa_kernel)
    env_tm_ms = time_ms(lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True))
    env_bm_ms = time_ms(lambda: env.fused_rollout(state, actions_bm, strict=True))
    sa_entry = lambda: env_sa.fused_sim_ahead(state, actions_bm, env_sa.tau, env_sa.tau, obs_stride=sa_stride,
                                              strict=True)
    env_sa_ms = time_ms(sa_entry)
    t_short = 256
    t0 = time.perf_counter()
    env.vmap_rollout(state, actions_bm[:, :t_short], t_short)
    torch.cuda.synchronize()
    vmap_ms = (time.perf_counter() - t0) * 1e3

    bound_ms, bound_by = bound(env, env._solver, B, T, T, 0, False)
    sa_bound_ms, sa_bound_by = bound(env_sa, env_sa._solver, B, T, T, T // sa_stride, True)
    steps = B * T
    log(f"[main] kernel (time-major slab): {ms!r} ms = {steps / ms * 1e3:.4e} env-steps/s; "
        f"bound {bound_ms!r} ms ({bound_by}); {bound_ms / ms:.1%} of the bound; "
        f"slab read at {slab_bytes / ms / 1e9:.3f} TB/s")
    log(f"[main] kernel (batch-major slab): {bm_ms!r} ms; slab read at {slab_bytes / bm_ms / 1e9:.3f} TB/s")
    log(f"[main] env.fused_rollout time-major: {env_tm_ms!r} ms = {steps / env_tm_ms * 1e3:.4e} env-steps/s")
    log(f"[main] env.fused_rollout batch-major: {env_bm_ms!r} ms = {steps / env_bm_ms * 1e3:.4e} env-steps/s "
        f"({env_bm_ms / env_tm_ms:.3f} x time-major)")
    log(f"[main] plain version, T={T}: {plain_ms!r} ms (one run)")
    log(f"[main] sim-ahead rk4 kernel: {sa_ms!r} ms; bound {sa_bound_ms!r} ms ({sa_bound_by}); "
        f"env.fused_sim_ahead (batch-major) {env_sa_ms!r} ms; plain {plain_sa_ms!r} ms (one run)")
    log(f"[main] vmap_rollout, T={t_short}: {vmap_ms!r} ms (one run) = "
        f"{B * t_short / vmap_ms * 1e3:.4e} env-steps/s")
    lib = K.build("stepper")
    pend = lambda stages, math="ExactMath": rf"stepper_kernel<float, PendulumEnv<{math}>, {stages}[,>]"
    anatomy("1a stepper step, Pendulum Euler", lib, pend(1), ms, env_tm_ms, B, T,
            lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True), "stepper_kernel",
            SASS_CASES[0][3], STEPPER_TILE_ROWS)
    anatomy("1a' the same, batch-major slab and entry", lib, pend(1), bm_ms, env_bm_ms, B, T,
            lambda: env.fused_rollout(state, actions_bm, strict=True), "stepper_kernel", SASS_CASES[0][3],
            STEPPER_TILE_ROWS)
    anatomy("1b stepper sim-ahead, Pendulum RK4", lib, pend(4), sa_ms, env_sa_ms, B, T, sa_entry, "stepper_kernel",
            SASS_CASES[1][3], STEPPER_TILE_ROWS)
    return [
        entry("stepper_step", launches["step"], err_step, ms, plain_ms, bound_ms, bound_by, SOURCE, REPLACES),
        entry("stepper_sim_ahead", launches["sim_ahead"], err_sa, sa_ms, plain_sa_ms, sa_bound_ms, sa_bound_by,
              SOURCE, REPLACES),
    ]


# ---------------------------------------------------------------------------
# PMSM drive phases
# ---------------------------------------------------------------------------

#: operations of the environment's constraint per step, counted from
#: csrc/pmsm_stepper.cu::env_constrain as the closed loop's hexagon is counted
#: (65, pmsm_cl_ops_per_step), its linear sector test (9) replaced by atan2
#: and three (sub, sin, compare): 65; and of the angle per step (step mode:
#: add, then the wrap's add, fmod, compare and sub; sim-ahead: the
#: extrapolated angle's multiply and add, the accumulation, the wrap at the
#: save): 7
PMSM_CONSTRAINT_OPS, PMSM_ANGLE_OPS = 65, 7
#: what the eager pre-pass alone took at this shape before the kernel took it
#: over (PERF.md, the earlier kernel's rows)
PMSM_EAGER_PREPASS = "19.4-27 ms"


def pmsm_ops(env, solver, n_steps, n_saves):
    """Arithmetic operations of one instance over a rollout of the PMSM
    kernel, counted from csrc/pmsm_stepper.cu with each add, multiply,
    divide, negation, compare, floor, clamp bound, sin, cos, atan2 and fmod
    as one: per step the constraint and the angle, the RK stages (each a
    gather and the ODE, or the linear ODE) and the combinations; a save's
    torque reuses the next step's first gather, and the final torque gathers
    once."""
    from exciting_environments_torch.ops.kernels.stepper import _stage_rows

    gather = 4 + 2 + 4 + 2 + 2 + 6 * 11  # offsets and scales, floor, clamp, weights, 6 blends
    saturated = bool(env.env_properties.saturated)
    ode = gather + 23 if saturated else 13
    a_rows, b = _stage_rows(solver)
    comb = lambda coeffs: sum(2 - (c == 1.0) for c in coeffs if c != 0.0) + 1 if any(coeffs) else 0
    per_step = PMSM_CONSTRAINT_OPS + PMSM_ANGLE_OPS + len(b) * ode + 2 * (sum(comb(r) for r in a_rows) + comb(b))
    return per_step * n_steps + 4 * n_saves + (gather if saturated else 0) + 4


def pmsm_bound(env, solver, batch, n_steps, n_saves, itemsize=4, n_noise=0):
    """Least time for the PMSM kernel's work: the normalized action slab, the
    six initial leaves (currents, angle, buffers, speed), per-batch
    parameters and bands and the interleaved table read once, the eight
    finals (six leaves and the last voltage) and the saves (currents,
    torque, angle, and with deadtime the buffers) written once, and a
    process-noise slab of ``n_noise`` columns read once (one add per column
    and step); or its operations at the float32 rate, whichever is larger."""
    from exciting_environments_torch.ops.kernels.pmsm_stepper import PMSM_PARAMS, kernel_bands

    props = env.env_properties
    n_pb = sum(isinstance(getattr(props.static_params, n), torch.Tensor) for n in PMSM_PARAMS)
    n_pb += sum(isinstance(v, torch.Tensor) for v in kernel_bands(props, batch).values())
    table = env._lut.interleaved().numel() if props.saturated else 0
    per_save = 4 + 2 * int(props.static_params.deadtime)
    nbytes = itemsize * (n_steps * batch * (2 + n_noise) + (6 + n_pb) * batch + table + 8 * batch
                         + per_save * n_saves * batch)
    return roofline(nbytes, (pmsm_ops(env, solver, n_steps, n_saves) + n_noise * n_steps) * batch)


def pmsm_env(ex, batch, variant="BRUSA", saturated=True, dtype=torch.float32, static=None, **kwargs):
    params = None
    if static:
        params = dict(ex.MotorVariant[variant].get_params().static_params.__dict__)
        if saturated:
            params.update(l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"))
        params.update(static)
    return ex.PMSM(batch_size=batch, saturated=saturated, motor_variant=ex.MotorVariant[variant],
                   static_params=params, device=DEVICE, dtype=dtype, **kwargs)


def pmsm_inputs(env, n_steps, gen, lim=0.9):
    """A reset state and uniform normalized actions in +-lim, time-major."""
    _, state = env.vmap_reset(rng=gen)
    u = torch.rand((n_steps, env.batch_size, 2), generator=gen, device=DEVICE, dtype=torch.float64)
    return state, ((u * 2 - 1) * lim).to(env.dtype)


def pmsm_run(PK, env, state, acts, kernel, **kw):
    """The PMSM kernel (or its plain version) from a State and normalized
    actions; returns every output tensor as one flat list."""
    state0, omega = PK._start(state)
    fn = PK.pmsm_kernel_rollout if kernel else PK.plain_pmsm_rollout
    final, u_last, traj = fn(env, acts, state0, omega, tau=kw.pop("tau", env.tau), **kw)
    return [t for part in (final, u_last, traj or ()) for t in part if t is not None]


def pmsm_deviation(PK, env, state, acts, **kw):
    outk = pmsm_run(PK, env, state, acts, True, **kw)
    outp = pmsm_run(PK, env, state, acts, False, **kw)
    torch.cuda.synchronize()
    if len(outk) != len(outp) or any(k.shape != p.shape for k, p in zip(outk, outp)):
        raise AssertionError("kernel and plain PMSM rollouts return different structures")
    return max_abs(outk, outp), all(bool(torch.isfinite(t).all()) for t in outk)


def phase_pmsm_kernel_vs_plain(ex, PK):
    """PMSM kernel (angle, constraint, deadtime and currents in one launch)
    against its plain version (the eager pre-pass, then the loop), B =
    65,536, T = 64, tolerance 0.0."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    B, T = B_MAIN, T_CHECK
    uni = lambda lo, hi: (lo + (hi - lo) * torch.rand(B, generator=gen, device=DEVICE, dtype=torch.float64)).float()
    an = dict(ex.MotorVariant.BRUSA.get_params().action_normalizations.__dict__)
    an["u_d"] = ex.MinMaxNormalization(min=an["u_d"].min, max=uni(200.0, 300.0))
    # (label, env, rollout kwargs).  The kernel performs the plain version's
    # operations in the same order and precision, so every case is 0.0.
    cases = [
        ("BRUSA saturated euler", pmsm_env(ex, B), {}),
        ("BRUSA saturated rk4", pmsm_env(ex, B, solver="rk4"), {}),
        ("BRUSA saturated tsit5", pmsm_env(ex, B, solver="tsit5"), {}),
        ("SEW saturated euler", pmsm_env(ex, B, "SEW"), {}),
        ("DEFAULT linear euler deadtime 1", pmsm_env(ex, B, "DEFAULT", saturated=False), {}),
        ("DEFAULT linear euler deadtime 0", pmsm_env(ex, B, "DEFAULT", saturated=False, static={"deadtime": 0}), {}),
        ("BRUSA saturated per-batch r_s and p", pmsm_env(
            ex, B, static={"r_s": uni(15e-3, 21e-3), "p": uni(2.0, 4.0)}), {}),
        ("DEFAULT linear per-batch l_d and l_q", pmsm_env(
            ex, B, "DEFAULT", saturated=False, static={"l_d": uni(0.3e-3, 0.45e-3), "l_q": uni(1.0e-3, 1.4e-3)}), {}),
        ("BRUSA saturated per-batch u_dc and u_d band, obs_stride=16", pmsm_env(
            ex, B, static={"u_dc": uni(350.0, 450.0)}, action_normalizations=an), {"obs_stride": 16}),
        ("BRUSA saturated euler obs_stride=4", pmsm_env(ex, B), {"obs_stride": 4}),
        ("BRUSA saturated euler deadtime 0 obs_stride=16", pmsm_env(ex, B, static={"deadtime": 0}),
         {"obs_stride": 16}),
        ("BRUSA saturated euler batch-major slab obs_stride=16", pmsm_env(ex, B), {"obs_stride": 16,
                                                                               "batch_major": True}),
        ("BRUSA saturated rk4 sim-ahead deadtime 1", pmsm_env(ex, B, solver="rk4"),
         {"sim_ahead": True, "obs_stride": 1}),
        ("BRUSA saturated rk4 sim-ahead deadtime 0 (next row constrained ahead)",
         pmsm_env(ex, B, solver="rk4", static={"deadtime": 0}), {"sim_ahead": True, "obs_stride": 1}),
        ("BRUSA saturated tsit5 sim-ahead deadtime 1 batch-major", pmsm_env(ex, B, solver="tsit5"),
         {"sim_ahead": True, "obs_stride": 1, "batch_major": True}),
        ("DEFAULT linear rk4 sim-ahead deadtime 0", pmsm_env(ex, B, "DEFAULT", saturated=False, solver="rk4",
                                                             static={"deadtime": 0}),
         {"sim_ahead": True, "obs_stride": 1}),
        ("BRUSA saturated euler ragged B=1000", pmsm_env(ex, 1000), {}),
        ("BRUSA saturated rk4 float64 (dynamic shared memory above 48 KB)",
         pmsm_env(ex, B, dtype=torch.float64, solver="rk4"), {"obs_stride": 8}),
        ("BRUSA saturated rk4 float64 sim-ahead deadtime 0", pmsm_env(ex, B, dtype=torch.float64, solver="rk4",
                                                                      static={"deadtime": 0}),
         {"sim_ahead": True, "obs_stride": 1}),
    ]
    failures = []
    for label, env, kw in cases:
        kw = dict(kw)
        state, acts = pmsm_inputs(env, T, gen)
        if kw.get("batch_major"):
            acts = acts.transpose(0, 1).contiguous()
        if kw.get("sim_ahead"):
            kw["tau"] = 2 * env.tau  # the solver's step differs from the constraint's env tau
        err, finite = pmsm_deviation(PK, env, state, acts, **kw)
        ok = finite and err == 0.0
        log(f"[pmsm kernel vs plain] {label}: max abs deviation {err!r} (tolerance 0.0) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"PMSM kernel disagrees with its plain version: {failures}")


def phase_sector(PK):
    """The environment's constraint in csrc/pmsm_stepper.cu keeps atan2f and
    three sinf sign tests: their results on the card against torch.atan2 and
    torch.sin, bit for bit, over 2^28 seeded pairs (within the constraint's
    range and over all magnitudes), the axes, signed zeros, infinities and
    NaN, and the hexagon's sector edges (angles k pi / 3 and their float32
    neighbours); any mismatch fails."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    totals = {"atan2": 0, "sector": 0, "inputs": 0}

    def check(alpha, beta):
        counts = PK.sector_mismatches(alpha.contiguous(), beta.contiguous())
        for key in totals:
            totals[key] += counts[key]

    chunk = 1 << 25
    for i in range(8):
        if i % 2 == 0:  # the constraint's range: |alpha|, |beta| up to 1.5
            alpha, beta = ((torch.rand((2, chunk), generator=gen, device=DEVICE) * 2 - 1) * 1.5).unbind(0)
        else:  # every magnitude: random bit patterns (NaN and infinities included)
            bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, chunk), generator=gen, device=DEVICE, dtype=torch.int32)
            alpha, beta = bits.view(torch.float32).unbind(0)
        check(alpha, beta)
    special = torch.tensor([0.0, -0.0, 1.0, -1.0, 1e-38, -1e-38, 1e-45, -1e-45, 3.4e38, -3.4e38,
                            float("inf"), float("-inf"), float("nan")], device=DEVICE)
    a, b = torch.meshgrid(special, special, indexing="ij")
    check(a.reshape(-1), b.reshape(-1))
    # the sector edges: radius r at angle k pi / 3, beta stepped up to 64
    # float32 ulps either way
    r = torch.linspace(1e-3, 1.5, 1024, device=DEVICE, dtype=torch.float64)
    k = torch.arange(-3, 4, device=DEVICE, dtype=torch.float64) * (np.pi / 3)
    theta, rad = torch.meshgrid(k, r, indexing="ij")
    a0 = (rad * torch.cos(theta)).float().reshape(-1)
    b0 = (rad * torch.sin(theta)).float().reshape(-1)
    steps = torch.arange(-64, 65, device=DEVICE, dtype=torch.int32)
    b_near = (b0.view(torch.int32)[:, None] + steps[None, :]).view(torch.float32)
    check(a0[:, None].expand_as(b_near).reshape(-1), b_near.reshape(-1))
    torch.cuda.synchronize()
    log(f"[sector] atan2f and the hexagon's sin sign bits against torch.atan2 / torch.sin: {totals} "
        f"in {time.perf_counter() - t0:.2f} s")
    if totals["atan2"] or totals["sector"] or totals["inputs"] < 1 << 28:
        raise AssertionError(f"the constraint's sector function differs from PyTorch's on this card: {totals}")


def phase_pmsm_golden(ex, PK):
    """PMSM golden fixture (linear magnetics, deadtime 1), float64, B = 1,
    1,000 steps through env.fused_rollout: one kernel launch."""
    from exciting_environments_torch.utils import load_sim_properties_from_json

    data = ROOT / "tests" / "envs" / "pmsm" / "data"
    params, action_norms, physical_norms, tau = load_sim_properties_from_json(data / "sim_properties.json")
    env = ex.PMSM(batch_size=1, tau=tau, solver="euler", static_params=params,
                  physical_normalizations=physical_norms, action_normalizations=action_norms,
                  device=DEVICE, dtype=torch.float64)
    stored = torch.as_tensor(np.load(data / "observations.npy"), device=DEVICE)
    actions = torch.as_tensor(np.load(data / "actions.npy"), device=DEVICE)
    n = actions.shape[0]
    state = env.generate_state_from_observation(stored[0][None], env.env_properties)
    before = PK.KERNEL.launches["pmsm_step"]
    obs, _ = env.fused_rollout(state, actions[None], obs_stride=1, strict=True)
    torch.cuda.synchronize()
    launches = PK.KERNEL.launches["pmsm_step"] - before
    generated = torch.cat([stored[:1], obs[0]], dim=0)
    dev = float((generated - stored).abs().max())
    ok = bool(torch.allclose(generated, stored, 1e-8)) and launches == 1
    log(f"[pmsm golden] fixture, {n} float64 steps in {launches} launch: max abs deviation {dev!r}, "
        f"allclose(rtol=1e-8) {ok}")
    if not ok:
        raise AssertionError("golden PMSM replay through the kernel deviates from the fixture")


class CallCounter:
    """Counts the calls of a module's or class's function while active, and
    puts the function back on exit."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, 0

    def __enter__(self):
        self.original = getattr(self.owner, self.name)

        def counted(*args, **kwargs):
            self.calls += 1
            return self.original(*args, **kwargs)

        setattr(self.owner, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.original)


def phase_pmsm_main(ex, PK):
    """PMSM main path at full width: BRUSA saturated, B = 65,536, T = 256,
    float32; returns the kernel table entries."""
    from exciting_environments_torch.ops.kernels.stepper import build as K_build

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    B, T, stride = B_MAIN, T_PMSM, 16
    env = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4, device=DEVICE)
    env_sa = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4,
                     solver="rk4", device=DEVICE)
    _, state = env.vmap_reset(rng=gen)
    u = torch.rand((B, T, 2), generator=gen, device=DEVICE, dtype=torch.float64)
    actions = ((u * 2 - 1) * 0.3).float()
    actions_tm = actions.transpose(0, 1).contiguous()
    log(f"[pmsm main] PMSM BRUSA saturated B={B} T={T} float32: normalized slab "
        f"{actions.numel() * 4 / 1e6:.1f} MB per layout")

    # the main path, with the eager pre-pass's two functions counted: on
    # the card it must call neither, and each entry point launches once
    PK.KERNEL.reset_counts()
    per_call = []
    with CallCounter(PK, "_eps_trajectory") as angle_loop, CallCounter(ex.PMSM, "_constrain") as constrain:
        for fn in (lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True),
                   lambda: env.fused_rollout(state, actions, strict=True),
                   lambda: env.fused_rollout(state, actions, obs_stride=stride, strict=True),
                   lambda: env_sa.fused_sim_ahead(state, actions, env_sa.tau, env_sa.tau, strict=True)):
            before = sum(PK.KERNEL.launches.values())
            per_call.append(fn())
            per_call[-1] = (per_call[-1], sum(PK.KERNEL.launches.values()) - before)
    torch.cuda.synchronize()
    (obs_tm, last_tm), (obs_bm, last_bm), (obs_tr, _), (obs_sa, last_sa) = [out for out, _ in per_call]
    launches = dict(PK.KERNEL.launches)
    log(f"[pmsm main] launches during the main path: {launches}, per entry-point call "
        f"{[n for _, n in per_call]}; eager pre-pass calls: _eps_trajectory {angle_loop.calls}, "
        f"PMSM._constrain {constrain.calls}")
    if any(n != 1 for _, n in per_call) or launches["pmsm_sim_ahead"] != 1:
        raise AssertionError(f"a PMSM main-path call did not make exactly one kernel launch: {launches}")
    if angle_loop.calls or constrain.calls:
        raise AssertionError("the PMSM main path ran the eager pre-pass on the card")
    shapes = (tuple(obs_tm.shape), tuple(obs_tr.shape), tuple(obs_sa.shape))
    if shapes != ((B, 8), (B, T // stride, 8), (B, T + 1, 8)):
        raise AssertionError(f"unexpected shapes {shapes}")
    if not all(bool(torch.isfinite(o).all()) for o in (obs_tm, obs_tr, obs_sa)):
        raise AssertionError("non-finite observations on the PMSM main path")
    if not (torch.equal(obs_tm, obs_bm) and torch.equal(last_tm.physical_state.i_d, last_bm.physical_state.i_d)):
        raise AssertionError("time-major and batch-major layouts disagree")
    if not torch.equal(obs_tr[:, -1], obs_tm):
        raise AssertionError("the last strided observation differs from the final one")

    step_kernel = lambda: pmsm_run(PK, env, state, actions_tm, True)
    bm_kernel = lambda: pmsm_run(PK, env, state, actions, True, batch_major=True)
    sa_kernel = lambda: pmsm_run(PK, env_sa, state, actions, True, obs_stride=1, sim_ahead=True, batch_major=True)
    err_step, _ = pmsm_deviation(PK, env, state, actions_tm)
    err_sa, _ = pmsm_deviation(PK, env_sa, state, actions, obs_stride=1, sim_ahead=True, batch_major=True)
    err_bm = max_abs(bm_kernel(), step_kernel())
    log(f"[pmsm main] kernel vs plain at full size: step max abs {err_step!r}, sim-ahead max abs {err_sa!r}; "
        f"batch-major vs time-major slab {err_bm!r}")
    if err_step != 0.0 or err_sa != 0.0 or err_bm != 0.0:
        raise AssertionError("PMSM kernel disagrees with its plain version at the main size")

    t0 = time.perf_counter()
    pmsm_run(PK, env, state, actions_tm, False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pmsm_run(PK, env_sa, state, actions_tm, False, obs_stride=1, sim_ahead=True)
    torch.cuda.synchronize()
    plain_sa_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    env.vmap_rollout(state, actions, T)
    torch.cuda.synchronize()
    vmap_ms = (time.perf_counter() - t0) * 1e3

    ms = time_ms(step_kernel)
    bm_ms = time_ms(bm_kernel)
    sa_ms = time_ms(sa_kernel)
    env_tm_ms = time_ms(lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True))
    env_bm_ms = time_ms(lambda: env.fused_rollout(state, actions, strict=True))
    env_sa_ms = time_ms(lambda: env_sa.fused_sim_ahead(state, actions, env_sa.tau, env_sa.tau, strict=True))

    # the kernel alone over a long slab, so that launch overhead drops out
    a_long = ((torch.rand((T_PMSM_LONG, B, 2), generator=gen, device=DEVICE) * 2 - 1) * 0.3).contiguous()
    long_ms = time_ms(lambda: pmsm_run(PK, env, state, a_long, True), reps=3)
    del a_long
    long_bound_ms, long_bound_by = pmsm_bound(env, env._solver, B, T_PMSM_LONG, 0)

    bound_ms, bound_by = pmsm_bound(env, env._solver, B, T, 0)
    sa_bound_ms, sa_bound_by = pmsm_bound(env_sa, env_sa._solver, B, T, T)
    steps = B * T
    per_step = pmsm_ops(env, env._solver, 2, 0) - pmsm_ops(env, env._solver, 1, 0)
    log(f"[pmsm main] kernel alone, euler step mode (time-major slab): {ms!r} ms = {steps / ms * 1e3:.4e} "
        f"env-steps/s; bound {bound_ms!r} ms ({bound_by}, {per_step} operations per step); "
        f"{bound_ms / ms:.1%} of the bound; batch-major slab {bm_ms!r} ms")
    log(f"[pmsm main] env.fused_rollout time-major: {env_tm_ms!r} ms = {steps / env_tm_ms * 1e3:.4e} env-steps/s "
        f"(kernel {ms / env_tm_ms:.1%}; the eager pre-pass alone took {PMSM_EAGER_PREPASS} before the kernel "
        f"took it over, PERF.md)")
    log(f"[pmsm main] env.fused_rollout batch-major: {env_bm_ms!r} ms = {steps / env_bm_ms * 1e3:.4e} env-steps/s "
        f"(kernel {bm_ms / env_bm_ms:.1%})")
    log(f"[pmsm main] sim-ahead rk4 kernel alone: {sa_ms!r} ms; bound {sa_bound_ms!r} ms ({sa_bound_by}); "
        f"env.fused_sim_ahead {env_sa_ms!r} ms (kernel {sa_ms / env_sa_ms:.1%})")
    log(f"[pmsm main] plain version: step {plain_ms!r} ms, sim-ahead {plain_sa_ms!r} ms (one run each)")
    log(f"[pmsm main] vmap_rollout, T={T}: {vmap_ms!r} ms (one run) = {steps / vmap_ms * 1e3:.4e} env-steps/s")
    log(f"[pmsm main] kernel alone, T={T_PMSM_LONG}: {long_ms!r} ms = "
        f"{B * T_PMSM_LONG / long_ms * 1e3:.4e} env-steps/s; bound {long_bound_ms!r} ms ({long_bound_by}); "
        f"{long_bound_ms / long_ms:.1%} of the bound")
    # the kernel on a fleet that stays inside its current bands (gathers
    # across the whole table, not on its edge cells)
    hold_state, hold_actions = holding_fleet(ex, env, gen, T)
    hold_ms = time_ms(lambda: pmsm_run(PK, env, hold_state, hold_actions, True, batch_major=True))
    log(f"[pmsm main] kernel alone on the holding fleet, T={T}, batch-major: {hold_ms!r} ms (random fleet "
        f"{bm_ms!r} ms)")
    del hold_actions
    lib = K_build("pmsm_stepper")
    for row, kms, ems, fn in (
            ("3a", ms, env_tm_ms, lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True)),
            ("3b", sa_ms, env_sa_ms, lambda: env_sa.fused_sim_ahead(state, actions, env_sa.tau, env_sa.tau,
                                                                    strict=True))):
        _, kernel_re, vias = sass_case(row)
        anatomy(f"{row} pmsm_stepper", lib, kernel_re, kms, ems, B, T, fn, "pmsm_kernel", vias)
    return [
        entry("pmsm_step", launches["pmsm_step"], err_step, ms, plain_ms, bound_ms, bound_by, PMSM_SOURCE,
              PMSM_REPLACES),
        entry("pmsm_sim_ahead", launches["pmsm_sim_ahead"], err_sa, sa_ms, plain_sa_ms, sa_bound_ms, sa_bound_by,
              PMSM_SOURCE, PMSM_REPLACES),
    ]


# ---------------------------------------------------------------------------
# closed-loop phases
# ---------------------------------------------------------------------------

PD_GAINS = [[-0.9, -0.25, 0.9]]  # benchmarks/r03/closed_loop_device.py's PD law
PI_LAW = dict(K=[[-0.9, -0.25, 0.9]], Ki=[[-2e-3, 0.0, 2e-3]], clip=1.0)  # ... stateful_closed_loop_device.py


def actor_tree(n_obs, hidden=(16, 16), n_action=1, seed=SEED, log_std=-1.0):
    """Actor weights made from ``seed`` with numpy, in the JAX package's
    layout (``{"actor": [{"w", "b"}, ...], "log_std", "seed"}``)."""
    rng = np.random.default_rng(seed)
    sizes = (n_obs, *hidden, n_action)
    layers = [{"w": rng.normal(0.0, 1.0 / np.sqrt(m), (m, n)), "b": rng.normal(0.0, 0.1, n)}
              for m, n in zip(sizes[:-1], sizes[1:])]
    return {"actor": layers, "log_std": np.full(n_action, log_std), "seed": float(seed + 101)}


def cl_policy_ops(spec, n_action):
    """Operations of one policy evaluation, counted from csrc/closed_loop.cu:
    each add, multiply, compare, integer shift/xor/multiply, conversion and
    each tanh/exp/log/sqrt/cos call as one."""
    o = spec.options
    if spec.policy_id in (4, 5, 6):  # the drive-control tiles
        return tile_policy_ops(spec)
    if spec.policy_id == 0:  # AffineLaw
        per_action = 2 * spec.n_obs + (2 * spec.n_obs + 1) * o["has_integral"] + 2 * o["has_clip"]
        return n_action * per_action
    widths = o["widths"]
    ops = sum(2 * m * n for m, n in zip(widths[:-1], widths[1:])) + sum(widths[1:-1]) + 1
    hash_ops = 8 + 2 * 8 + 3 + 2 + 3 + 6  # counter, two mix32, shifts and salt, conversions, uniforms, Box-Muller
    return ops + n_action * (2 + (0 if o["deterministic"] else hash_ops + 3))


def cl_bound(env, spec, batch, n_steps, n_saves, n_carry, n_refs, n_obs_noise=0, n_proc_noise=0, itemsize=4):
    """Least time for the closed-loop kernel's work: its inputs (state,
    references, carry, per-batch parameters, policy parameters and per-drive
    planes, noise slabs)
    read once and its outputs (final state and carry, saves) written once,
    over the memory rate; or its operations over the float32 rate (integer
    operations counted at that rate too), whichever is larger."""
    from exciting_environments_torch.ops.kernels.stepper import _stage_rows

    n, a = len(env._ode_state_fields), env.action_dim
    params = env.env_properties.static_params
    n_pb = sum(isinstance(getattr(params, p), torch.Tensor) for p in env._kernel_params)
    nbytes = itemsize * (batch * (2 * n + n_refs + 2 * n_carry + n_pb + len(spec.planes)) + spec.flat.numel()
                         + n_saves * batch * (n + a + n_carry) + n_steps * batch * (n_obs_noise + n_proc_noise))
    a_rows, b = _stage_rows(env._solver)
    comb = lambda coeffs: sum(2 - (c == 1.0) for c in coeffs if c != 0.0) + 1 if any(coeffs) else 0
    svm, clip = constraint_ops(env)
    wrap = 5 * len(env._angle_fields) + clip
    per_step = 4 * n + n_obs_noise + cl_policy_ops(spec, a) + 4 * a + svm
    per_step += len(b) * ode_ops(env) + n * (sum(comb(r) for r in a_rows) + comb(b)) + wrap
    per_step += (n_proc_noise + wrap) if n_proc_noise else 0
    ops = per_step * batch * n_steps
    return roofline(nbytes, ops), per_step


def cl_run(CL, env, policy, n_steps, y0, refs, kernel, **kw):
    fn = CL.kernel_closed_loop if kernel else CL.plain_closed_loop
    return fn(env, y0, policy, n_steps, tau=env.tau, solver=env._solver, props=env.env_properties,
              ref_leaves=refs, **kw)


def cl_flat(out):
    """Every tensor of a closed-loop result (final, carry, saves)."""
    return [t for part in out if part is not None for t in part]


def cl_deviation(CL, env, policy, n_steps, y0, refs, **kw):
    outk = cl_flat(cl_run(CL, env, policy, n_steps, y0, refs, True, **kw))
    outp = cl_flat(cl_run(CL, env, policy, n_steps, y0, refs, False, **kw))
    torch.cuda.synchronize()
    if len(outk) != len(outp) or any(k.shape != p.shape for k, p in zip(outk, outp)):
        raise AssertionError("kernel and plain closed loops return different structures")
    return max_abs(outk, outp), all(bool(torch.isfinite(t).all()) for t in outk)


def phase_cl_kernel_vs_plain(ex, CL):
    """Closed-loop kernel against its plain version, B = 65,536, T = 64,
    float32 unless stated, tolerance 0.0."""
    from exciting_environments_torch.utils.convert import actor_params_from_numpy

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    B, T = B_MAIN, T_CHECK
    pend = lambda batch=B, **kw: make_env(ex.Pendulum, batch, control_state=["theta"], **kw)
    zeros = lambda env: (torch.zeros(env.batch_size, device=DEVICE, dtype=env.dtype),)
    lengths = (1.0 + torch.rand(B, generator=gen, device=DEVICE)).to(torch.float32)
    pd, pi = ex.AffinePolicy(PD_GAINS), ex.AffinePolicy(**PI_LAW)
    rl_env = pend(tau=2e-2)
    actor, ids = ex.make_actor_tile(rl_env)
    greedy, _ = ex.make_actor_tile(rl_env, deterministic=True)
    weights = actor_params_from_numpy(rl_env, actor_tree(3))
    noisy = pend(solver="rk4")
    noise = dict(
        obs_noise_tm=(0.05 * torch.randn((T, B, 2), generator=gen, device=DEVICE)), obs_noise_cols=(0, 2),
        proc_noise_tm=(0.01 * torch.randn((T, B, 2), generator=gen, device=DEVICE)), proc_noise_idx=(0, 1),
    )
    pi64 = pend(solver="rk4", dtype=torch.float64)
    # (label, env, policy, loop kwargs)
    cases = [
        ("pendulum euler PD obs_stride=1", pend(), pd, {"traj_stride": 1}),
        ("pendulum rk4 PI (integrator carry, clip, carry saves)", pend(solver="rk4"), pi, {"traj_stride": 1}),
        ("cart_pole tsit5 affine over 4 state + 1 reference columns",
         make_env(ex.CartPole, B, solver="tsit5", control_state=["deflection"]),
         ex.AffinePolicy([[-0.5, -0.3, 0.8, 0.2, 0.5]]), {"traj_stride": 8}),
        ("mass_spring_damper heun affine with offset",
         make_env(ex.MassSpringDamper, B, solver="heun", control_state=["deflection"]),
         ex.AffinePolicy([[-0.6, -0.2, 0.6]], b=[0.05]), {}),
        ("pendulum euler per-batch l", pend(static_params={"l": lengths, "m": 1.0, "g": 9.81}), pd,
         {"traj_stride": 1}),
        ("pendulum rk4 obs-noise and process-noise slabs", noisy, pd, {"traj_stride": 1, **noise}),
        ("pendulum tau=2e-2 actor (16, 16) exploring", rl_env, actor, {"traj_stride": 1, "policy_params": weights}),
        ("pendulum tau=2e-2 actor (16, 16) deterministic", rl_env, greedy,
         {"traj_stride": 1, "policy_params": weights}),
        ("pendulum rk4 PI float64", pi64, pi, {"traj_stride": 1}),
        ("pendulum rk4 PD ragged B=1000", pend(1000, solver="rk4"), pd, {"traj_stride": 1}),
        ("pendulum rk4 PI obs_stride=4", pend(solver="rk4"), pi, {"traj_stride": 4}),
    ]
    failures = []
    for label, env, policy, kw in cases:
        kw = dict(kw)
        if policy.n_carry:
            kw["policy_carry"] = ids if policy in (actor, greedy) else zeros(env)
        y0 = random_state(env, gen)
        refs = tuple((torch.rand(env.batch_size, generator=gen, device=DEVICE, dtype=torch.float64) * 2 - 1)
                     .to(env.dtype) for _ in env.control_state)
        err, finite = cl_deviation(CL, env, policy, T, y0, refs, **kw)
        ok = finite and err == 0.0
        log(f"[closed loop vs plain] {label}: max abs deviation {err!r} (tolerance 0.0) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"closed-loop kernel disagrees with its plain version: {failures}")


def phase_cl_main(ex, CL):
    """Closed-loop main path at full width: Pendulum B = 65,536 tracking
    linspace(-1.5, 1.5) references with the PD law and the PI law over
    T = 4,096 (final state only), and the exploring actor collected through
    RolloutCollector.collect_policy_fused over T = 64 (tau = 2e-2, a save
    every step); returns the kernel table entries."""
    from exciting_environments_torch.ops.kernels.stepper import build as K_build
    from exciting_environments_torch.utils.convert import actor_params_from_numpy

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    B, T, T_RL = B_MAIN, T_MAIN, T_CHECK

    def tracking_env(**kw):
        env = ex.Pendulum(batch_size=B, control_state=["theta"], device=DEVICE, **kw)
        _, state = env.vmap_reset(rng=gen)
        state.reference.theta = torch.linspace(-1.5, 1.5, B, device=DEVICE, dtype=env.dtype)
        y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
        refs = (env.env_properties.physical_normalizations.theta.normalize(state.reference.theta),)
        return env, state, y0, refs

    env, state, y0, refs = tracking_env()
    pd, pi = ex.AffinePolicy(PD_GAINS), ex.AffinePolicy(**PI_LAW)
    c0 = (torch.zeros(B, device=DEVICE),)
    log(f"[closed loop main] Pendulum B={B} tau={env.tau} float32 euler, references linspace(-1.5, 1.5); "
        f"PD and PI over T={T}, the actor over T={T_RL}")
    entries = []

    def run_case(name, drive, kernel_fn, plain_fn, check, spec, n_steps, n_saves, n_carry, cl_env, row):
        CL.CL_KERNEL.reset_counts()
        out = drive()
        torch.cuda.synchronize()
        launches = CL.CL_KERNEL.launches["closed_loop"]
        log(f"[closed loop main] {name}: launches during the main path {launches}")
        if launches < 1:
            raise AssertionError(f"the {name} main path did not go through the closed-loop kernel")
        check(out)
        outk = cl_flat(kernel_fn())
        t0 = time.perf_counter()
        outp = cl_flat(plain_fn())
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs(outk, outp)
        if err != 0.0:
            raise AssertionError(f"{name}: kernel disagrees with its plain version at the main size ({err!r})")
        ms = time_ms(kernel_fn)
        env_ms = time_ms(drive)
        (bound_ms, bound_by), per_step = cl_bound(cl_env, spec, B, n_steps, n_saves, n_carry, 1)
        steps = B * n_steps
        log(f"[closed loop main] {name}: kernel {ms!r} ms = {steps / ms * 1e3:.4e} env-steps/s; "
            f"entry point {env_ms!r} ms = {steps / env_ms * 1e3:.4e} env-steps/s (kernel {ms / env_ms:.1%}); "
            f"bound {bound_ms!r} ms ({bound_by}, {per_step} operations per step and instance); "
            f"{bound_ms / ms:.1%} of the bound; plain {plain_ms!r} ms (one run); max abs {err!r}")
        _, kernel_re, vias = sass_case(row)
        anatomy(f"{row} {name}", K_build("closed_loop"), kernel_re, ms, env_ms, B, n_steps, drive,
                "closed_loop_kernel", vias)
        entries.append(entry(name, launches, err, ms, plain_ms, bound_ms, bound_by, CL_SOURCE, CL_REPLACES))

    def check_final(out, n_extra=0):
        obs = out[0]
        if tuple(obs.shape) != (B, 3) or len(out) != 2 + n_extra or not bool(torch.isfinite(obs).all()):
            raise AssertionError(f"unexpected final-only closed-loop result: {tuple(obs.shape)}")
        if float(obs[:, 0].abs().max()) > 1.0:
            raise AssertionError("wrapped angle left the normalized band")
        log(f"[closed loop main]   mean |ref - theta| of the normalized angle after {T} steps: "
            f"{float((obs[:, 2] - obs[:, 0]).abs().mean()):.4f}")

    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs)
    run_case("closed_loop_pd", lambda: env.fused_closed_loop(state, pd, T),
             lambda: CL.kernel_closed_loop(env, y0, pd, T, **kw), lambda: CL.plain_closed_loop(env, y0, pd, T, **kw),
             check_final, pd.kernel_spec(torch.float32, DEVICE), T, 0, 0, env, "2a")
    run_case("closed_loop_pi", lambda: env.fused_closed_loop(state, pi, T, policy_carry=c0),
             lambda: CL.kernel_closed_loop(env, y0, pi, T, policy_carry=c0, **kw),
             lambda: CL.plain_closed_loop(env, y0, pi, T, policy_carry=c0, **kw),
             lambda out: check_final(out, 1), pi.kernel_spec(torch.float32, DEVICE), T, 0, 1, env, "2b")

    rl_env, rl_state, rl_y0, rl_refs = tracking_env(tau=2e-2)
    actor, ids = ex.make_actor_tile(rl_env)
    weights = actor_params_from_numpy(rl_env, actor_tree(3))
    collector = ex.RolloutCollector(rl_env)
    rl_kw = dict(tau=rl_env.tau, solver=rl_env._solver, props=rl_env.env_properties, ref_leaves=rl_refs,
                 traj_stride=1, policy_params=weights, policy_carry=ids)

    def check_batch(out):
        batch, final, carry = out
        shapes = (tuple(batch.observations.shape), tuple(batch.actions.shape), tuple(batch.rewards.shape))
        if shapes != ((B, T_RL, 3), (B, T_RL, 1), (B, T_RL, 1)):
            raise AssertionError(f"unexpected trajectory batch shapes {shapes}")
        if not all(bool(torch.isfinite(x).all()) for x in (batch.observations, batch.actions, batch.rewards)):
            raise AssertionError("non-finite trajectory batch")
        if float(batch.actions.abs().max()) > 1.0 or not torch.equal(carry[0], ids[0]):
            raise AssertionError("actor actions left [-1, 1] or the id carry changed")
        log(f"[closed loop main]   collected {B}x{T_RL} steps, mean reward {float(batch.rewards.mean()):.4f}, "
            f"action std {float(batch.actions.std()):.4f}")

    run_case("closed_loop_actor",
             lambda: collector.collect_policy_fused(actor, rl_state, T_RL, policy_params=weights, policy_carry=ids),
             lambda: CL.kernel_closed_loop(rl_env, rl_y0, actor, T_RL, **rl_kw),
             lambda: CL.plain_closed_loop(rl_env, rl_y0, actor, T_RL, **rl_kw),
             check_batch, actor.kernel_spec(torch.float32, DEVICE, weights), T_RL, T_RL, 1, rl_env, "2c")
    return entries


# ---------------------------------------------------------------------------
# PMSM closed-loop phases
# ---------------------------------------------------------------------------

PCL_SOURCE = "exciting_environments_torch/csrc/pmsm_closed_loop.cu"
PCL_REPLACES = "exciting_environments_tpu/ops/pallas/pmsm_stepper.py:1832"
B_PCL_CHECK, T_PCL = 4096, 2048
# the P law a = -0.6 (obs_i - ref_i) of benchmarks/r03/pmsm_closed_loop_device.py and the PI law
# a = 0.6 e + int, int += 0.01 e of benchmarks/r03/pmsm_stateful_closed_loop_device.py:47-52, over
# the 8 drive columns and the (i_d, i_q) references
PCL_P = [[-0.6, 0, 0, 0, 0, 0, 0, 0, 0.6, 0], [0, -0.6, 0, 0, 0, 0, 0, 0, 0, 0.6]]
PCL_KI = [[-0.01, 0, 0, 0, 0, 0, 0, 0, 0.01, 0], [0, -0.01, 0, 0, 0, 0, 0, 0, 0, 0.01]]
SENSOR_SIGMA, OMEGA_SENSORLESS = 3.0, 1200.0  # benchmarks/r05/saturated_sensorless_device.py:36-39
#: operations of one evaluation of the sensorless laws, counted from csrc/pmsm_closed_loop.cu
SENSORLESS_LAW_OPS = {2: 76, 3: 105}


def pmsm_cl_ops_per_step(env, spec, n_refs, n_sched, n_obs_noise, n_proc_noise):
    """Arithmetic operations of one closed-loop step of one drive, counted
    from csrc/pmsm_closed_loop.cu as pmsm_ops counts the open loop (each add,
    multiply, divide, negation, compare, floor, clamp bound, sqrt, sin, cos
    and fmod as one)."""
    from exciting_environments_torch.ops.kernels.stepper import _stage_rows

    gather = lambda nc: 4 + 2 + 4 + 2 + 2 + nc * 11
    saturated = bool(env.env_properties.saturated)
    # the per-drive scheduled tile (ScheduledDriveLaw) reads i_d and i_q only: no torque (its gather feeds the
    # first stage), no cos/sin eps, no buffer column
    currents = spec.policy_id == 3 and bool(spec.planes)
    torque = (gather(6) if currents else gather(6) + 4) if saturated else 4
    obs = (2 * 4 if currents else 5 * 4 + 2) + n_obs_noise  # normalized columns (omega once per run), cos, sin
    sched = (8 + gather(n_sched)) if n_sched else 0
    if spec.policy_id == 0:
        o = spec.options
        policy = 2 * (2 * spec.n_obs + (2 * spec.n_obs + 1) * o["has_integral"] + 2 * o["has_clip"])
    elif spec.policy_id == 1:  # the actor, counted as in csrc/closed_loop.cu
        policy = cl_policy_ops(spec, 2)
    else:
        policy = SENSORLESS_LAW_OPS[spec.policy_id]
    hexagon = 65
    a_rows, b = _stage_rows(env._solver)
    ode_first = 23 if saturated else 13  # the first stage reuses the torque's gather
    ode_more = gather(6) + 23 if saturated else 13
    comb = lambda coeffs: sum(2 - (c == 1.0) for c in coeffs if c != 0.0) + 1 if any(coeffs) else 0
    rk = ode_first + (len(b) - 1) * ode_more + 2 * (sum(comb(r) for r in a_rows) + comb(b))
    angle = 7
    return torque + obs + sched + policy + hexagon + rk + n_proc_noise + angle


def pmsm_cl_bound(env, spec, batch, n_steps, n_saves, n_carry, n_refs, n_sched=0, n_obs_noise=0, n_proc_noise=0,
                  itemsize=4):
    """Least time for the PMSM closed-loop kernel's work: its inputs (state,
    speed, references, carry, per-batch parameters and bands, policy
    parameters, the tables, the slabs) read once and its outputs (finals,
    last voltage, carry, saves) written once, over the memory rate; or its
    operations over the float32 rate, whichever is larger."""
    from exciting_environments_torch.ops.kernels.pmsm_closed_loop import cl_bands
    from exciting_environments_torch.ops.kernels.pmsm_stepper import PMSM_PARAMS

    props = env.env_properties
    n_pb = sum(isinstance(getattr(props.static_params, n), torch.Tensor) for n in PMSM_PARAMS)
    n_pb += sum(isinstance(leaf, torch.Tensor) for leaf in cl_bands(props).values())
    cells = env._lut.nx * env._lut.ny if env._lut is not None else 0
    tables = (6 * cells if props.saturated else 0) + n_sched * cells
    nbytes = itemsize * (batch * (6 + n_refs + 2 * n_carry + n_pb + 8) + spec.flat.numel() + tables
                         + n_saves * batch * (7 + n_carry) + n_steps * batch * (n_obs_noise + n_proc_noise))
    per_step = pmsm_cl_ops_per_step(env, spec, n_refs, n_sched, n_obs_noise, n_proc_noise)
    return roofline(nbytes, per_step * batch * n_steps), per_step


def pcl_run(PCL, env, policy, n_steps, state0, omega, kernel, **kw):
    fn = PCL.kernel_pmsm_closed_loop if kernel else PCL.plain_pmsm_closed_loop
    return fn(env, state0, omega, policy, n_steps, tau=env.tau, solver=env._solver, props=env.env_properties, **kw)


def pcl_deviation(PCL, env, policy, n_steps, state0, omega, **kw):
    outk = cl_flat(pcl_run(PCL, env, policy, n_steps, state0, omega, True, **kw))
    outp = cl_flat(pcl_run(PCL, env, policy, n_steps, state0, omega, False, **kw))
    torch.cuda.synchronize()
    if len(outk) != len(outp) or any(k.shape != p.shape for k, p in zip(outk, outp)):
        raise AssertionError("kernel and plain PMSM closed loops return different structures")
    return max_abs(outk, outp), all(bool(torch.isfinite(t).all()) for t in outk)


def pcl_inputs(env, gen, omega=None):
    """A reset drive state (random currents, angle and speed, or the speed
    pinned to ``omega``), its (i_d, i_q) references spread over the bands,
    and their normalized leaves."""
    _, state = env.vmap_reset(rng=gen)
    B = env.batch_size
    phys = state.physical_state
    if isinstance(omega, torch.Tensor):
        phys.omega_el = omega.clone()
    elif omega is not None:
        phys.omega_el = torch.full((B,), omega, device=DEVICE, dtype=env.dtype)
    state.reference.i_d = torch.linspace(-200.0, -10.0, B, device=DEVICE, dtype=env.dtype)
    state.reference.i_q = torch.linspace(-150.0, 150.0, B, device=DEVICE, dtype=env.dtype)
    pn = env.env_properties.physical_normalizations
    refs = tuple(getattr(pn, n).normalize(getattr(state.reference, n)) for n in env.control_state)
    state0 = (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
    return state, state0, phys.omega_el, refs


def sensor_slab(env, n_steps, gen, sigma=SENSOR_SIGMA):
    """A sigma-A current-sensor slab (n_steps, B, 2) in normalized units,
    drawn on the card; row 0 is zero (the first observation is exact)."""
    pn = env.env_properties.physical_normalizations
    scale = torch.tensor([2 * sigma / (pn.i_d.max - pn.i_d.min), 2 * sigma / (pn.i_q.max - pn.i_q.min)],
                         device=DEVICE, dtype=env.dtype)
    slab = torch.randn((n_steps, env.batch_size, 2), generator=gen, device=DEVICE, dtype=env.dtype) * scale
    slab[0] = 0.0
    return slab


def phase_pcl_kernel_vs_plain(ex, PCL):
    """PMSM closed-loop kernel against its plain version, B = 4,096, T = 64,
    float32 unless stated, tolerance 0.0."""
    from exciting_environments_torch.utils.convert import actor_params_from_numpy

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    B, T = B_PCL_CHECK, T_CHECK
    uni = lambda lo, hi: (lo + (hi - lo) * torch.rand(B, generator=gen, device=DEVICE, dtype=torch.float64)).float()
    tracking = lambda variant="BRUSA", saturated=True, **kw: pmsm_env(ex, B, variant, saturated,
                                                                       control_state=["i_d", "i_q"], **kw)
    p_law, pi_law = ex.AffinePolicy(PCL_P), ex.AffinePolicy(PCL_P, Ki=PCL_KI, clip=1.0)
    noise = dict(obs_noise_tm=0.02 * torch.randn((T, B, 2), generator=gen, device=DEVICE), obs_noise_cols=(0, 9),
                 proc_noise_tm=0.5 * torch.randn((T, B, 2), generator=gen, device=DEVICE), proc_noise_idx=(0, 1))
    an = dict(ex.MotorVariant.BRUSA.get_params().action_normalizations.__dict__)
    an["u_d"] = ex.MinMaxNormalization(min=an["u_d"].min, max=uni(200.0, 300.0))
    brusa_pb = tracking(static={"r_s": uni(15e-3, 21e-3), "u_dc": uni(350.0, 450.0)}, action_normalizations=an)
    sensorless_env = lambda deadtime, solver="euler": pmsm_env(ex, B, "DEFAULT", False, static={"deadtime": deadtime},
                                                               solver=solver)
    sched_env = pmsm_env(ex, B)
    sched_tile, sched_c0, sched_lut = ex.make_pmsm_saturated_sensorless_current_tile(
        sched_env, i_d_ref=-100.0, i_q_ref=150.0, omega_el=OMEGA_SENSORLESS,
        measurement_std={"i_d": SENSOR_SIGMA, "i_q": SENSOR_SIGMA})
    # the same tile per drive: 7 speed slices, per-drive references
    drive_env = pmsm_env(ex, B, control_state=["i_d", "i_q"])
    drive_omega = torch.linspace(0.0, 1000.0, 7, device=DEVICE)[torch.randint(0, 7, (B,), generator=gen, device=DEVICE)]
    drive_tile, drive_c0, drive_lut = ex.make_pmsm_saturated_sensorless_current_tile(
        drive_env, i_d_ref=uni(-200.0, -10.0), i_q_ref=uni(-150.0, 150.0), omega_el=drive_omega,
        measurement_std={"i_d": 2.5, "i_q": 2.5})
    # (label, env, policy, loop kwargs, pinned omega)
    cases = [
        ("BRUSA euler P deadtime 1, a save every step", tracking(), p_law, {"traj_stride": 1}, None),
        ("BRUSA rk4 PI (carry, clip), saves every 16", tracking(solver="rk4"), pi_law, {"traj_stride": 16}, None),
        ("BRUSA tsit5 PI deadtime 0 (u_last)", tracking(solver="tsit5", static={"deadtime": 0}), pi_law,
         {"traj_stride": 1}, None),
        ("DEFAULT linear euler P deadtime 0", tracking("DEFAULT", False, static={"deadtime": 0}), p_law,
         {"traj_stride": 1}, None),
        ("DEFAULT linear rk4 PI deadtime 1", tracking("DEFAULT", False, solver="rk4"), pi_law, {"traj_stride": 1},
         None),
        ("BRUSA euler PI per-batch r_s, u_dc and u_d max", brusa_pb, pi_law, {"traj_stride": 1}, None),
        ("BRUSA euler PI sensor and process slabs", tracking(), pi_law, {"traj_stride": 1, **noise}, None),
        ("BRUSA rk4 PI, its gains at call time (every column built), sensor slab on the torque",
         tracking(solver="rk4"), pi_law, {"traj_stride": 1, "policy_params": pi_law.flat_params().float().to(DEVICE),
                                          "obs_noise_tm": noise["obs_noise_tm"], "obs_noise_cols": (3, 9)}, None),
        ("DEFAULT linear sensorless tile deadtime 0", sensorless_env(0), "linear", {"traj_stride": 1},
         OMEGA_SENSORLESS),
        ("DEFAULT linear rk4 sensorless tile deadtime 1", sensorless_env(1, "rk4"), "linear", {"traj_stride": 4},
         OMEGA_SENSORLESS),
        ("BRUSA scheduled sensorless tile deadtime 1", sched_env, sched_tile, {"traj_stride": 1, "sched_lut": sched_lut},
         OMEGA_SENSORLESS),
        ("BRUSA scheduled sensorless tile per drive, 7 speed slices", drive_env, drive_tile,
         {"traj_stride": 1, "sched_lut": drive_lut}, drive_omega),
        ("BRUSA rk4 PI float64 (shared memory above 48 KB)", tracking(solver="rk4", dtype=torch.float64), pi_law,
         {"traj_stride": 8}, None),
        ("BRUSA euler P ragged B=1000", pmsm_env(ex, 1000, control_state=["i_d", "i_q"]), p_law, {}, None),
        # the PPO actor (family 1): ActorReg<16, 16>, and ActorLaw at (24, 8)
        ("BRUSA euler actor exploring, a save every step", tracking(), "actor", {"traj_stride": 1}, None),
        ("BRUSA euler actor deterministic", tracking(), "actor deterministic", {"traj_stride": 1}, None),
        ("BRUSA rk4 actor exploring float64, sensor slab", tracking(solver="rk4", dtype=torch.float64), "actor",
         {"traj_stride": 1, "sensors": True}, None),
        ("DEFAULT linear euler actor exploring, sensor slab", tracking("DEFAULT", False), "actor",
         {"traj_stride": 1, "sensors": True}, None),
        ("DEFAULT linear rk4 actor deterministic float64", tracking("DEFAULT", False, solver="rk4",
                                                                    dtype=torch.float64), "actor deterministic",
         {"traj_stride": 4}, None),
        ("BRUSA euler actor (24, 8) exploring (ActorLaw)", tracking(), "actor 24x8", {"traj_stride": 1}, None),
    ]
    failures = []
    for label, env, policy, kw, omega in cases:
        kw = dict(kw)
        sensors = kw.pop("sensors", False)
        if isinstance(policy, str) and policy.startswith("actor"):
            hidden = (24, 8) if policy.endswith("24x8") else (16, 16)
            policy, kw["policy_carry"] = ex.make_actor_tile(env, deterministic=policy.endswith("deterministic"))
            kw["policy_params"] = actor_params_from_numpy(env, actor_tree(10, hidden, n_action=2, log_std=-1.0))
        elif policy == "linear":
            policy, carry0 = ex.make_pmsm_sensorless_current_tile(
                env, i_d_ref=-30.0, i_q_ref=60.0, omega_el=omega, measurement_std={"i_d": 5.0, "i_q": 5.0})
            kw["policy_carry"] = carry0
        elif policy is sched_tile:
            kw["policy_carry"] = sched_c0
        elif policy is drive_tile:
            kw["policy_carry"] = drive_c0
        elif policy.n_carry:
            kw["policy_carry"] = tuple(torch.zeros(env.batch_size, device=DEVICE, dtype=env.dtype) for _ in range(2))
        _, state0, omega_t, refs = pcl_inputs(env, gen, omega)
        if policy.policy_id in (2, 3) or sensors:
            kw["obs_noise_tm"], kw["obs_noise_cols"] = sensor_slab(env, T, gen), (0, 1)
        for name in ("obs_noise_tm", "proc_noise_tm"):
            if name in kw:
                kw[name] = kw[name].to(env.dtype)
        err, finite = pcl_deviation(PCL, env, policy, T, state0, omega_t, ref_leaves=refs, **kw)
        ok = finite and err == 0.0
        log(f"[pmsm closed loop vs plain] {label}: max abs deviation {err!r} (tolerance 0.0) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"PMSM closed-loop kernel disagrees with its plain version: {failures}")


def phase_pcl_main(ex, PCL):
    """PMSM closed-loop main cases at full width: saturated BRUSA, B = 65,536,
    float32, Euler, tau = 1e-4, deadtime 1, control_state (i_d, i_q); returns
    the kernel table entries.  A: the P law over T = 2,048, final state only;
    B: the PI law over T = 2,048; C: the gain-scheduled sensorless tile over
    T = 2,048 with a 3 A sensor slab; D: the PI law collected through
    RolloutCollector.collect_policy_fused over T = 256."""
    from exciting_environments_torch.ops.kernels.stepper import build

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    B, T, T_D = B_MAIN, T_PCL, T_PMSM
    env = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4,
                  control_state=["i_d", "i_q"], device=DEVICE)
    state, state0, omega, refs = pcl_inputs(env, gen)
    p_law, pi_law = ex.AffinePolicy(PCL_P), ex.AffinePolicy(PCL_P, Ki=PCL_KI)
    zeros2 = lambda: tuple(torch.zeros(B, device=DEVICE) for _ in range(2))
    log(f"[pmsm closed loop main] PMSM BRUSA saturated B={B} float32 euler tau={env.tau} deadtime "
        f"{env.env_properties.static_params.deadtime}; P and PI over T={T}, the sensorless tile over T={T}, "
        f"collection over T={T_D}")
    entries = []

    def run_case(name, drive, kernel_fn, plain_fn, check, bound_args, n_steps, row, law="AffineCurrentsReg",
                 vias=((),), full=None):
        PCL.PMSM_CL_KERNEL.reset_counts()
        out = drive()
        torch.cuda.synchronize()
        launches = PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"]
        log(f"[pmsm closed loop main] {name}: launches during the main path {launches}")
        if launches != 1:
            raise AssertionError(f"the {name} main path made {launches} pmsm_closed_loop launches, not 1")
        check(out)
        outk = cl_flat(kernel_fn())
        t0 = time.perf_counter()
        outp = cl_flat(plain_fn())
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs(outk, outp)
        del outp
        if err != 0.0:
            raise AssertionError(f"{name}: kernel disagrees with its plain version at the main size ({err!r})")
        ms = time_ms(kernel_fn)
        env_ms = time_ms(drive)
        (bound_ms, bound_by), per_step = pmsm_cl_bound(*bound_args)
        steps = B * n_steps
        log(f"[pmsm closed loop main] {name}: kernel {ms!r} ms = {steps / ms * 1e3:.4e} env-steps/s; "
            f"entry point {env_ms!r} ms = {steps / env_ms * 1e3:.4e} env-steps/s (kernel {ms / env_ms:.1%}); "
            f"bound {bound_ms!r} ms ({bound_by}, {per_step} operations per step and drive); "
            f"{bound_ms / ms:.1%} of the bound; plain {plain_ms!r} ms (one run, full size); max abs {err!r}")
        anatomy(f"{row} {name}", build("pmsm_closed_loop"), rf"pmsm_closed_loop_kernel<float, 1, true, {law}[,>]",
                ms, env_ms, B, n_steps, drive, "pmsm_closed_loop_kernel", vias=vias)
        entries.append(entry(name, launches, err, ms, plain_ms, bound_ms, bound_by, PCL_SOURCE, PCL_REPLACES))
        if full is None:
            return
        # the same gains given at call time: the instantiation that builds every column
        full_kernel, full_drive = full
        before = PCL.VARIANT_LAUNCHES["affine_all"]
        err_full = max_abs(cl_flat(full_kernel()), outk)
        torch.cuda.synchronize()
        if PCL.VARIANT_LAUNCHES["affine_all"] != before + 1 or err_full != 0.0:
            raise AssertionError(f"{name}: the full law's launch ({PCL.VARIANT_LAUNCHES['affine_all'] - before}) "
                                 f"disagrees with the pruned one ({err_full!r})")
        ms_full, env_ms_full = time_ms(full_kernel), time_ms(full_drive)
        log(f"[pmsm closed loop main] {name} affine_all (every column built): kernel {ms_full!r} ms against the "
            f"pruned {ms!r} ms ({ms / ms_full:.3f}x the time); entry point {env_ms_full!r} ms; {bound_ms / ms_full:.1%} "
            f"of the bound; max abs from the pruned launch {err_full!r}")
        anatomy(f"{row}-all {name}", build("pmsm_closed_loop"),
                r"pmsm_closed_loop_kernel<float, 1, true, AffineAdapter[,>]", ms_full, env_ms_full, B, n_steps,
                full_drive, "pmsm_closed_loop_kernel")
        entries.append(entry(f"{name}_affine_all", 1, err_full, ms_full, plain_ms, bound_ms, bound_by, PCL_SOURCE,
                             PCL_REPLACES))

    def check_final(out, n_extra=0):
        obs = out[0]
        if tuple(obs.shape) != (B, 10) or len(out) != 2 + n_extra or not bool(torch.isfinite(obs).all()):
            raise AssertionError(f"unexpected final-only closed-loop result: {tuple(obs.shape)}")
        phys = out[1].physical_state
        err_d = (phys.i_d - state.reference.i_d).abs().mean()
        err_q = (phys.i_q - state.reference.i_q).abs().mean()
        log(f"[pmsm closed loop main]   mean |i_ref - i| after {T} steps: d {float(err_d):.3f} A, "
            f"q {float(err_q):.3f} A")

    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs)
    p_gains, pi_gains = (law.flat_params().float().to(DEVICE) for law in (p_law, pi_law))
    run_case("pmsm_closed_loop_p", lambda: env.fused_closed_loop(state, p_law, T),
             lambda: PCL.kernel_pmsm_closed_loop(env, state0, omega, p_law, T, **kw),
             lambda: PCL.plain_pmsm_closed_loop(env, state0, omega, p_law, T, **kw), check_final,
             (env, p_law.kernel_spec(torch.float32, DEVICE), B, T, 0, 0, 2), T, "4a",
             full=(lambda: PCL.kernel_pmsm_closed_loop(env, state0, omega, p_law, T, policy_params=p_gains, **kw),
                   lambda: env.fused_closed_loop(state, p_law, T, policy_params=p_gains)))
    c0 = zeros2()
    run_case("pmsm_closed_loop_pi", lambda: env.fused_closed_loop(state, pi_law, T, policy_carry=c0),
             lambda: PCL.kernel_pmsm_closed_loop(env, state0, omega, pi_law, T, policy_carry=c0, **kw),
             lambda: PCL.plain_pmsm_closed_loop(env, state0, omega, pi_law, T, policy_carry=c0, **kw),
             lambda out: check_final(out, 1), (env, pi_law.kernel_spec(torch.float32, DEVICE), B, T, 0, 2, 2), T, "4b",
             full=(lambda: PCL.kernel_pmsm_closed_loop(env, state0, omega, pi_law, T, policy_carry=c0,
                                                       policy_params=pi_gains, **kw),
                   lambda: env.fused_closed_loop(state, pi_law, T, policy_carry=c0, policy_params=pi_gains)))

    # C: gain-scheduled sensorless control, the fleet pinned at omega_el = 1200 rad/s
    senv = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4, device=DEVICE)
    tile, sc0, sched = ex.make_pmsm_saturated_sensorless_current_tile(
        senv, i_d_ref=-100.0, i_q_ref=150.0, omega_el=OMEGA_SENSORLESS,
        measurement_std={"i_d": SENSOR_SIGMA, "i_q": SENSOR_SIGMA})
    _, s_state0, s_omega, _ = pcl_inputs(senv, gen, OMEGA_SENSORLESS)
    slab = sensor_slab(senv, T, gen)
    log(f"[pmsm closed loop main] sensorless: {SENSOR_SIGMA} A sensor slab {tuple(slab.shape)}, "
        f"{slab.numel() * slab.element_size() / 1e9:.3f} GB, drawn on the card")
    skw = dict(policy_carry=sc0, sched_lut=sched, obs_noise_tm=slab, obs_noise_cols=(0, 1))
    pn = senv.env_properties.physical_normalizations

    def check_sensorless(out):
        final, _, carry, _, _ = out
        i_d, i_q = final[0].double(), final[1].double()
        b_d = (carry[0].double() + 1) / 2 * (pn.i_d.max - pn.i_d.min) + pn.i_d.min
        b_q = (carry[1].double() + 1) / 2 * (pn.i_q.max - pn.i_q.min) + pn.i_q.min
        mean_d, mean_q = float(i_d.mean()), float(i_q.mean())
        rmse_d = float(((b_d - i_d) ** 2).mean().sqrt())
        rmse_q = float(((b_q - i_q) ** 2).mean().sqrt())
        log(f"[pmsm closed loop main]   sensorless after {T} steps: mean i_d {mean_d:.4f} A (setpoint -100), "
            f"mean i_q {mean_q:.4f} A (setpoint 150), mean |error| d {float((i_d + 100).abs().mean()):.4f} A, "
            f"q {float((i_q - 150).abs().mean()):.4f} A; belief RMSE d {rmse_d:.4f} A, q {rmse_q:.4f} A "
            f"(sensor {SENSOR_SIGMA} A)")
        if not (abs(mean_d + 100) < 1.0 and abs(mean_q - 150) < 1.5 and max(rmse_d, rmse_q) < SENSOR_SIGMA):
            raise AssertionError("the sensorless fleet did not settle, or its belief is worse than the sensor")

    sensorless = lambda kernel: pcl_run(PCL, senv, tile, T, s_state0, s_omega, kernel, **skw)
    run_case("pmsm_closed_loop_sensorless", lambda: PCL.pmsm_closed_loop(senv, s_state0, s_omega, tile, T, **skw),
             lambda: sensorless(True), lambda: sensorless(False), check_sensorless,
             (senv, tile.kernel_spec(torch.float32, DEVICE), B, T, 0, 6, 0, 10, 2), T, "4c",
             "ScheduledLaw", sass_case("4c")[2])
    del slab, skw

    # H: the same tile per drive over the speed x current plane (the benchmark cell
    # pmsm-brusa-sched-sensorless-fleet-t2048): 32 speed slices over 0..1,000 rad/s,
    # references over -200..-10 A and -150..150 A, a cold observer, no sensor slab
    denv = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4,
                   control_state=["i_d", "i_q"], device=DEVICE)
    draw = lambda lo, hi: (lo + (hi - lo) * torch.rand(B, generator=gen, device=DEVICE, dtype=torch.float64)).float()
    d_omega = torch.linspace(0.0, 1000.0, 32, device=DEVICE)[torch.randint(0, 32, (B,), generator=gen, device=DEVICE)]
    d_ref = (draw(-200.0, -10.0), draw(-150.0, 150.0))
    t_solve = time.perf_counter()
    dtile, dc0, dsched = ex.make_pmsm_saturated_sensorless_current_tile(
        denv, i_d_ref=d_ref[0], i_q_ref=d_ref[1], omega_el=d_omega, measurement_std={"i_d": 2.5, "i_q": 2.5})
    log(f"[pmsm closed loop main] per-drive sensorless: {dsched.n_slices} speed slices solved in "
        f"{time.perf_counter() - t_solve:.2f} s")
    d_state, d_state0, _, _ = pcl_inputs(denv, gen, d_omega)
    d_state.reference.i_d, d_state.reference.i_q = d_ref
    pnd = denv.env_properties.physical_normalizations
    d_refs = (pnd.i_d.normalize(d_ref[0]), pnd.i_q.normalize(d_ref[1]))
    dkw_cl = dict(policy_carry=dc0, sched_lut=dsched, ref_leaves=d_refs)

    def check_drive(out):
        final, _, carry, _, _ = out
        err_d = (final[0].double() - d_ref[0].double()).abs()
        err_q = (final[1].double() - d_ref[1].double()).abs()
        log(f"[pmsm closed loop main]   per-drive sensorless after {T} steps: mean |error| d {float(err_d.mean()):.4f} A, "
            f"q {float(err_q.mean()):.4f} A, largest {float(torch.maximum(err_d, err_q).max()):.4f} A")
        if not (bool(torch.isfinite(final[0]).all()) and float(torch.maximum(err_d, err_q).max()) < 1.0):
            raise AssertionError("the per-drive sensorless fleet did not settle on its references")

    per_drive = lambda kernel: pcl_run(PCL, denv, dtile, T, d_state0, d_omega, kernel, **dkw_cl)
    run_case("pmsm_closed_loop_sensorless_per_drive",
             lambda: PCL.pmsm_closed_loop(denv, d_state0, d_omega, dtile, T, **dkw_cl),
             lambda: per_drive(True), lambda: per_drive(False), check_drive,
             (denv, dtile.kernel_spec(torch.float32, DEVICE), B, T, 0, 6, 2, 10), T, "4h",
             "ScheduledDriveLaw", sass_case("4h")[2])
    log(f"[pmsm closed loop main] per-drive sensorless: slice staging over the row's launches {PCL.SLICE_STAGING}")

    # D: the PI law collected with rewards and flags, a save every step
    collector = ex.RolloutCollector(env)
    dkw = dict(kw, traj_stride=1, policy_carry=c0)

    def check_batch(out):
        batch, final, carry = out
        shapes = (tuple(batch.observations.shape), tuple(batch.actions.shape), tuple(batch.rewards.shape))
        if shapes != ((B, T_D, 10), (B, T_D, 2), (B, T_D, 1)):
            raise AssertionError(f"unexpected trajectory batch shapes {shapes}")
        if not all(bool(torch.isfinite(x).all()) for x in (batch.observations, batch.actions, batch.rewards)):
            raise AssertionError("non-finite trajectory batch")
        log(f"[pmsm closed loop main]   collected {B}x{T_D} steps, mean reward {float(batch.rewards.mean()):.6f}, "
            f"terminated share {float(batch.terminated.float().mean()):.4f}")

    run_case("pmsm_closed_loop_collect",
             lambda: collector.collect_policy_fused(pi_law, state, T_D, policy_carry=c0),
             lambda: PCL.kernel_pmsm_closed_loop(env, state0, omega, pi_law, T_D, **dkw),
             lambda: PCL.plain_pmsm_closed_loop(env, state0, omega, pi_law, T_D, **dkw), check_batch,
             (env, pi_law.kernel_spec(torch.float32, DEVICE), B, T_D, T_D, 2, 2), T_D, "4d")
    from exciting_environments_torch.ops.kernels.pmsm_stepper import _eps_trajectory

    replay_ms = time_ms(lambda: _eps_trajectory(state0[2], omega, env.tau, T_D, env._solver))
    log(f"[pmsm closed loop main] pmsm_closed_loop_collect: the eager {T_D}-step angle replay of the trajectory "
        f"alone {replay_ms!r} ms")
    return entries


# ---------------------------------------------------------------------------
# fast-math phases
# ---------------------------------------------------------------------------

FAST_SOURCE = "exciting_environments_torch/csrc/pendulum_fast.cu"
FAST_REPLACES = "exciting_environments_tpu/ops/pallas/pendulum_fast.py:40"
PMSM_FAST_SOURCE = "exciting_environments_torch/csrc/pmsm_fast.cu"
PMSM_FAST_REPLACES = "exciting_environments_tpu/ops/pallas/pmsm_fast_kernel.py:78"
ATOL_FAST, CHAIN = 1e-2, 6  # bench.py:39-42, the fast pendulum's gate over six chained rollouts
T_SUSTAINED = 16384  # bench.py's path 4b
PENDULUM_FAST_OPS = 30  # per step, counted from csrc/pendulum_fast.cu
#: per step of csrc/pmsm_fast.cu (saturated: with the 80-operation gather), and the final torque
PMSM_FAST_OPS = {True: (166, 84), False: (80, 4)}
B_FAST_CHECK = 4096
#: the fast kernels take 0.2-0.5 ms, near their wrappers' host work: besides one call (their "ms", as every
#: kernel's), each is also timed over this many calls back to back, where a call's host work overlaps the card's
FAST_CHAIN = 10


def wrapped_gap(a, b):
    """max |a - b| of two angle tensors, modulo 2 pi."""
    d = (a.double() - b.double() + np.pi).remainder(2 * np.pi) - np.pi
    return float(d.abs().max())


def phase_fast_flag(ex, K, CL):
    """fast_math=True through the stepper and closed-loop kernels: kernel vs
    plain at B = 65,536, T = 64 (float32, one float64 case, a ragged B),
    tolerance 0.0; then the fast pendulum's step mode and PD law at the main
    size (T = 4,096); returns the kernel table entries."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    B, T = B_MAIN, T_CHECK
    fast = lambda cls, batch=B, **kw: make_env(cls, batch, fast_math=True, **kw)
    # (label, env, rollout kwargs); states span +-4 so that the wraps fire
    cases = [
        ("pendulum fast euler", fast(ex.Pendulum), {}),
        ("pendulum fast rk4 obs_stride=4", fast(ex.Pendulum, solver="rk4"), {"obs_stride": 4}),
        ("pendulum fast euler sim-ahead ratio 2", fast(ex.Pendulum), {"sim_ahead": True, "hold": 2, "obs_stride": 8}),
        ("pendulum fast rk4 sim-ahead ratio 1", fast(ex.Pendulum, solver="rk4"),
         {"sim_ahead": True, "hold": 1, "obs_stride": 8}),
        ("cart_pole fast tsit5", fast(ex.CartPole, solver="tsit5"), {}),
        ("pendulum fast rk4 float64", fast(ex.Pendulum, solver="rk4", dtype=torch.float64), {}),
        ("cart_pole fast euler ragged B=1000", fast(ex.CartPole, 1000), {}),
    ]
    failures = []
    for label, env, kw in cases:
        y0 = tuple(4 * y for y in random_state(env, gen))
        acts = random_actions(env, T // kw.get("hold", 1), gen)
        yk, tk = K.kernel_rollout(env, y0, acts, tau=env.tau, **kw)
        yp, tp = K.plain_rollout(env, y0, acts, tau=env.tau, **kw)
        torch.cuda.synchronize()
        err = max(max_abs(yk, yp), max_abs(tk, tp) if tk is not None else 0.0)
        ok = err == 0.0 and all(bool(torch.isfinite(y).all()) for y in yk)
        log(f"[fast flag vs plain] {label}: max abs deviation {err!r} (tolerance 0.0) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    pd = ex.AffinePolicy(PD_GAINS)
    for label, env in (("pendulum fast euler PD closed loop, saves every step",
                        fast(ex.Pendulum, control_state=["theta"])),
                       ("pendulum fast rk4 PD closed loop ragged B=1000",
                        fast(ex.Pendulum, 1000, control_state=["theta"], solver="rk4"))):
        y0 = tuple(4 * y for y in random_state(env, gen))
        refs = ((torch.rand(env.batch_size, generator=gen, device=DEVICE) * 2 - 1),)
        err, finite = cl_deviation(CL, env, pd, T, y0, refs, traj_stride=1)
        ok = finite and err == 0.0
        log(f"[fast flag vs plain] {label}: max abs deviation {err!r} (tolerance 0.0) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"fast-math kernels disagree with their plain versions: {failures}")

    # the main size: Pendulum(fast_math=True), step mode and the PD law, T = 4,096
    Tm = T_MAIN
    env = ex.Pendulum(batch_size=B, tau=1e-4, fast_math=True, device=DEVICE)
    _, state = env.vmap_reset(rng=gen)
    actions_tm = random_actions(env, Tm, gen)
    K.KERNEL.reset_counts()
    obs, last = env.fused_rollout(state, actions_tm, time_major=True, strict=True)
    torch.cuda.synchronize()
    launches = K.KERNEL.launches["step"]
    if launches != 1 or tuple(obs.shape) != (B, 2) or not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"the fast-math rollout did not run once through the stepper kernel: {launches}")
    y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
    kernel = lambda: K.kernel_rollout(env, y0, actions_tm, tau=env.tau)
    yk, _ = kernel()
    t0 = time.perf_counter()
    yp, _ = K.plain_rollout(env, y0, actions_tm, tau=env.tau)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs(yk, yp)
    if err != 0.0:
        raise AssertionError(f"fast-math stepper kernel disagrees with its plain version at the main size ({err!r})")
    ms = time_ms(kernel)
    env_ms = time_ms(lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True))
    bound_ms, bound_by = bound(env, env._solver, B, Tm, Tm, 0, False)
    log(f"[fast flag main] Pendulum(fast_math=True) B={B} T={Tm} step mode: kernel {ms!r} ms = "
        f"{B * Tm / ms * 1e3:.4e} env-steps/s; env.fused_rollout time-major {env_ms!r} ms; bound {bound_ms!r} ms "
        f"({bound_by}, {ops_per_step(env, env._solver, False)} operations per step); plain {plain_ms!r} ms; "
        f"launches {launches}")
    anatomy("1c stepper step, Pendulum fast_math Euler", K.build("stepper"),
            r"stepper_kernel<float, PendulumEnv<FastMath>, 1[,>]", ms, env_ms, B, Tm,
            lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True), "stepper_kernel",
            SASS_CASES[2][3], STEPPER_TILE_ROWS)
    entries = [entry("stepper_step_fast", launches, err, ms, plain_ms, bound_ms, bound_by, SOURCE, REPLACES)]

    cl_env = ex.Pendulum(batch_size=B, control_state=["theta"], fast_math=True, device=DEVICE)
    _, cl_state = cl_env.vmap_reset(rng=gen)
    cl_state.reference.theta = torch.linspace(-1.5, 1.5, B, device=DEVICE)
    cy0 = tuple(getattr(cl_state.physical_state, f) for f in cl_env._ode_state_fields)
    refs = (cl_env.env_properties.physical_normalizations.theta.normalize(cl_state.reference.theta),)
    CL.CL_KERNEL.reset_counts()
    obs, _ = cl_env.fused_closed_loop(cl_state, pd, Tm)
    torch.cuda.synchronize()
    cl_launches = CL.CL_KERNEL.launches["closed_loop"]
    if cl_launches != 1 or not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"the fast-math PD loop did not run once through the closed-loop kernel: {cl_launches}")
    kw = dict(tau=cl_env.tau, solver=cl_env._solver, props=cl_env.env_properties, ref_leaves=refs)
    cl_kernel = lambda: CL.kernel_closed_loop(cl_env, cy0, pd, Tm, **kw)
    outk = cl_flat(cl_kernel())
    t0 = time.perf_counter()
    outp = cl_flat(CL.plain_closed_loop(cl_env, cy0, pd, Tm, **kw))
    torch.cuda.synchronize()
    cl_plain_ms = (time.perf_counter() - t0) * 1e3
    cl_err = max_abs(outk, outp)
    if cl_err != 0.0:
        raise AssertionError(f"fast-math closed-loop kernel disagrees with its plain version ({cl_err!r})")
    cl_ms = time_ms(cl_kernel)
    cl_env_ms = time_ms(lambda: cl_env.fused_closed_loop(cl_state, pd, Tm))
    (cl_bound_ms, cl_bound_by), per_step = cl_bound(cl_env, pd.kernel_spec(torch.float32, DEVICE), B, Tm, 0, 0, 1)
    log(f"[fast flag main] PD law, fast_math=True, T={Tm}: kernel {cl_ms!r} ms; env.fused_closed_loop "
        f"{cl_env_ms!r} ms; bound {cl_bound_ms!r} ms ({cl_bound_by}, {per_step} operations per step); "
        f"plain {cl_plain_ms!r} ms; launches {cl_launches}; mean |ref - theta| (normalized) "
        f"{float((obs[:, 2] - obs[:, 0]).abs().mean()):.4f}")
    _, kernel_re, vias = sass_case("2d")
    anatomy("2d closed_loop_pd_fast", K.build("closed_loop"), kernel_re, cl_ms, cl_env_ms, B, Tm,
            lambda: cl_env.fused_closed_loop(cl_state, pd, Tm), "closed_loop_kernel", vias)
    entries.append(entry("closed_loop_pd_fast", cl_launches, cl_err, cl_ms, cl_plain_ms, cl_bound_ms, cl_bound_by,
                         CL_SOURCE, CL_REPLACES))
    return entries


def phase_pendulum_fast(ex, PFK):
    """Kernel 5: kernel vs plain at 0.0 through the entry point (B = 65,536
    and a ragged B, T = 64, both layouts; T = 4,099, which ends inside a ring
    tile and whose batch-major rows are no 16-byte multiples, both layouts;
    T = 4,100, 16-byte rows and a ragged last tile; a horizon shorter than a
    tile); the main case Pendulum(batch_size=65536, tau=1e-4), actions in
    +-1, T = 4,096 in both layouts, one launch each, the batch-major slab
    read in place (no more extra memory than the slab); the bench gate
    against six chained exact rollouts; the sustained T = 16,384 time-major
    slab.  Returns the kernel table entry."""
    from exciting_environments_torch.ops.kernels.stepper import build as K_build

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    uniform = lambda *shape: torch.rand(shape, generator=gen, device=DEVICE) * 2 - 1

    def plain(env, state, acts_tm):
        phys = state.physical_state
        return PFK.plain_pendulum_fast_rollout(phys.theta, phys.omega, acts_tm[..., 0], **PFK.fast_constants(env))

    failures = []
    for label, batch, n_steps, time_major in (
            ("B=65536 batch-major", B_MAIN, T_CHECK, False), ("B=65536 time-major", B_MAIN, T_CHECK, True),
            ("ragged B=65531 time-major", B_MAIN - 5, T_CHECK, True),
            ("ragged B=65531 batch-major", B_MAIN - 5, T_CHECK, False),
            ("T=4099 time-major (ends inside a tile)", B_FAST_CHECK, 4099, True),
            ("T=4099 batch-major (rows no 16-byte multiple)", B_FAST_CHECK, 4099, False),
            ("T=4100 batch-major (16-byte rows, ragged last tile)", B_FAST_CHECK, 4100, False),
            ("T=7 batch-major ragged B=1000 (shorter than a tile)", 1000, 7, False)):
        env = ex.Pendulum(batch_size=batch, tau=1e-4, device=DEVICE)
        _, state = env.vmap_reset(rng=gen)
        acts_tm = uniform(n_steps, batch, 1)
        acts = acts_tm if time_major else acts_tm.transpose(0, 1).contiguous()
        got = ex.pendulum_fast_rollout(env, state, acts, time_major=time_major)
        ref = plain(env, state, acts_tm)
        torch.cuda.synchronize()
        err = max_abs(got, ref)
        ok = err == 0.0 and all(bool(torch.isfinite(x).all()) for x in got)
        log(f"[pendulum fast vs plain] {label}: max abs deviation {err!r} (tolerance 0.0) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"the fast pendulum kernel disagrees with its plain version: {failures}")

    B, T = B_MAIN, T_MAIN
    env = ex.Pendulum(batch_size=B, tau=1e-4, device=DEVICE)
    _, state = env.vmap_reset(rng=gen)
    actions_tm = uniform(T, B, 1)
    actions_bm = actions_tm.transpose(0, 1).contiguous()
    launches, finals = {}, {}
    for layout, acts, tm in (("time-major", actions_tm, True), ("batch-major", actions_bm, False)):
        PFK.KERNEL.reset_counts()
        finals[layout] = th, om = ex.pendulum_fast_rollout(env, state, acts, time_major=tm)
        torch.cuda.synchronize()
        launches[layout] = PFK.KERNEL.launches["pendulum_fast"]
        if launches[layout] != 1 or tuple(th.shape) != (B,) or not bool(torch.isfinite(th).all()):
            raise AssertionError(f"the fast pendulum ({layout}) did not run once through its kernel: {launches}")
    log(f"[pendulum fast main] Pendulum B={B} T={T} float32, actions in +-1: launches {launches}")
    # the batch-major slab is read in place: the same results, and no copy
    # (the entry point's extra memory stays below the slab's)
    err_bm = max_abs(finals["batch-major"], finals["time-major"])
    slab_bytes = actions_bm.numel() * actions_bm.element_size()
    extra = extra_memory(lambda: ex.pendulum_fast_rollout(env, state, actions_bm))
    log(f"[pendulum fast main] batch-major slab read in place: vs time-major max abs {err_bm!r}; "
        f"pendulum_fast_rollout batch-major allocated at most {extra} B beyond its inputs (slab {slab_bytes} B)")
    if err_bm != 0.0 or extra >= slab_bytes:
        raise AssertionError("the fast pendulum copied its batch-major slab, or read it differently")
    consts = PFK.fast_constants(env)
    phys = state.physical_state
    kernel = lambda: PFK.kernel_pendulum_fast_rollout(phys.theta, phys.omega, actions_tm[..., 0], **consts)
    got = kernel()
    t0 = time.perf_counter()
    ref = plain(env, state, actions_tm)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs(got, ref)
    if err != 0.0:
        raise AssertionError(f"the fast pendulum kernel disagrees with its plain version at the main size ({err!r})")
    ms = time_ms(kernel)
    ms_chain = time_ms(kernel, chain=FAST_CHAIN)
    kernel_bm_ms = time_ms(lambda: PFK.kernel_pendulum_fast_rollout(phys.theta, phys.omega, actions_bm[..., 0],
                                                                    batch_major=True, **consts), chain=FAST_CHAIN)
    tm_ms = time_ms(lambda: ex.pendulum_fast_rollout(env, state, actions_tm, time_major=True))
    bm_ms = time_ms(lambda: ex.pendulum_fast_rollout(env, state, actions_bm))
    tm_chain_ms = time_ms(lambda: ex.pendulum_fast_rollout(env, state, actions_tm, time_major=True), chain=FAST_CHAIN)
    bm_chain_ms = time_ms(lambda: ex.pendulum_fast_rollout(env, state, actions_bm), chain=FAST_CHAIN)
    exact_ms = time_ms(lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True))
    bound_ms, bound_by = roofline(4 * (T * B + 4 * B), PENDULUM_FAST_OPS * B * T)
    steps = B * T
    log(f"[pendulum fast main] kernel (one call) {ms!r} ms = {steps / ms * 1e3:.4e} env-steps/s; bound "
        f"{bound_ms!r} ms ({bound_by}); {bound_ms / ms:.1%} of the bound. {FAST_CHAIN} calls back to back: "
        f"{ms_chain!r} ms per call ({bound_ms / ms_chain:.1%} of the bound; slab read at "
        f"{4 * T * B / ms_chain / 1e9:.3f} TB/s), batch-major slab {kernel_bm_ms!r} ms "
        f"({bound_ms / kernel_bm_ms:.1%} of the bound)")
    log(f"[pendulum fast main] pendulum_fast_rollout time-major {tm_ms!r} ms, batch-major {bm_ms!r} ms (one call; "
        f"{FAST_CHAIN} calls back to back: {tm_chain_ms!r}, {bm_chain_ms!r} ms per call); the exact "
        f"env.fused_rollout time-major {exact_ms!r} ms; plain version {plain_ms!r} ms (one run)")
    _, kernel_re, vias = sass_case("5")
    anatomy("5 pendulum_fast", K_build("pendulum_fast"), kernel_re, ms, tm_ms, B, T,
            lambda: ex.pendulum_fast_rollout(env, state, actions_tm, time_major=True), "pendulum_fast_kernel", vias)

    # bench.py's gate: six chained rollouts, fast against exact, from one state
    fast_state, exact_state = state, state
    for _ in range(CHAIN):
        th, om = ex.pendulum_fast_rollout(env, fast_state, actions_tm, time_major=True)
        fast_state = ex.core.structures.replace(
            fast_state, physical_state=env.PhysicalState(theta=th, omega=om))
        _, exact_state = env.fused_rollout(exact_state, actions_tm, time_major=True, strict=True)
    gate = wrapped_gap(th, exact_state.physical_state.theta)
    log(f"[pendulum fast main] bench gate: max wrapped |d theta| after {CHAIN} x {T} chained steps {gate!r} rad "
        f"(limit {ATOL_FAST}) {'ok' if gate < ATOL_FAST else 'FAIL'}")
    if not gate < ATOL_FAST:
        raise AssertionError("the fast pendulum left the bench gate")
    del actions_bm, ref, got

    # sustained: one T = 16,384 time-major slab (4.3 GB)
    a_long = uniform(T_SUSTAINED, B)
    long_ms = time_ms(lambda: PFK.kernel_pendulum_fast_rollout(phys.theta, phys.omega, a_long, **consts), reps=3)
    long_bound, _ = roofline(4 * (T_SUSTAINED * B + 4 * B), PENDULUM_FAST_OPS * B * T_SUSTAINED)
    log(f"[pendulum fast main] sustained T={T_SUSTAINED} time-major ({a_long.numel() * 4 / 1e9:.2f} GB slab): "
        f"{long_ms!r} ms = {B * T_SUSTAINED / long_ms * 1e3:.4e} env-steps/s; bound {long_bound!r} ms; "
        f"{long_bound / long_ms:.1%} of the bound")
    del a_long
    return [entry("pendulum_fast", launches["time-major"], err, ms, plain_ms, bound_ms, bound_by,
                  FAST_SOURCE, FAST_REPLACES)]


def pmsm_fast_bound(env, batch, n_steps, itemsize=4):
    """Least time for the fast PMSM kernel's work: the action slab, the nine
    per-drive inputs and the table read once, the five outputs written once;
    or its operations at the float32 rate."""
    saturated = bool(env.env_properties.saturated)
    lut = env._lut.values.numel() if saturated else 0
    per_step, final = PMSM_FAST_OPS[saturated]
    return roofline(itemsize * (n_steps * batch * 2 + 14 * batch + lut), (per_step * n_steps + final) * batch)


def exact_and_fast(env, state, acts):
    """The final physical states of the exact env.fused_rollout and of
    env.fast_rollout on the same inputs."""
    _, exact = env.fused_rollout(state, acts, strict=True)
    return exact.physical_state, env.fast_rollout(state, acts).physical_state


def current_scale(phys):
    """The largest final current, at least 1 A: what the gaps are divided by."""
    return max(1.0, float(phys.i_d.abs().max()), float(phys.i_q.abs().max()))


def current_gap(a, b, scale):
    """max |d i_d|, |d i_q| between two final states, in float64, over ``scale``."""
    return max(float((a.i_d.double() - b.i_d.double()).abs().max()),
               float((a.i_q.double() - b.i_q.double()).abs().max())) / scale


def out_of_band(env, phys):
    """The share of drives whose currents end outside their i_d/i_q bands."""
    pn = env.env_properties.physical_normalizations
    out = (phys.i_d < pn.i_d.min) | (phys.i_d > pn.i_d.max) | (phys.i_q < pn.i_q.min) | (phys.i_q > pn.i_q.max)
    return float(out.float().mean())


def holding_fleet(ex, env, gen, n_steps, dither=0.005):
    """A fleet that stays inside its current bands and so reads the whole
    table: start currents across the inner 80% of the i_d/i_q bands, speeds
    up to 30% of the band (the holding voltages stay inside the hexagon's
    inscribed circle), and actions that hold each drive at its start
    currents (the steady-state dq voltages from the table there, also in
    the deadtime buffer) plus a uniform dither.  Returns the state and the
    batch-major actions."""
    B = env.batch_size
    pn = env.env_properties.physical_normalizations
    rand = lambda *shape: torch.rand(shape, generator=gen, device=DEVICE, dtype=torch.float64)
    i_d = (rand(B) * 0.8 + 0.1) * pn.i_d.min
    i_q = (rand(B) * 1.6 - 0.8) * pn.i_q.max
    omega = rand(B) * 0.3 * pn.omega_el.max
    lut = env._lut
    vals = ex.ops.lut.bilinear_gather(lut.values.double(), lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny, i_d, i_q)
    r_s = float(env.env_properties.static_params.r_s)
    u_d, u_q = r_s * i_d - omega * vals[5], r_s * i_q + omega * vals[4]
    an = env.env_properties.action_normalizations
    hold = torch.stack([u_d / an.u_d.max, u_q / an.u_q.max], -1)
    actions = (hold[:, None, :] + (rand(B, n_steps, 2) * 2 - 1) * dither).to(env.dtype)
    _, state = env.vmap_reset(rng=gen)
    with ex.core.structures.copy_and_mutate(state) as state:
        for name, v in (("i_d", i_d), ("i_q", i_q), ("omega_el", omega), ("u_d_buffer", u_d), ("u_q_buffer", u_q)):
            setattr(state.physical_state, name, v.to(env.dtype))
    return state, actions


class TensorMethodCounter(CallCounter):
    """Counts the calls of a ``torch.Tensor`` method while active (the
    method lives on a C base class, so the counter is set on
    ``torch.Tensor`` and taken off again on exit)."""

    def __init__(self, name):
        super().__init__(torch.Tensor, name)

    def __exit__(self, *exc):
        delattr(torch.Tensor, self.name)


def phase_pmsm_fast(ex, PF, PMK):
    """Kernel 6: kernel vs plain at 0.0 through env.fast_rollout (B = 4,096,
    T = 64, over DEFAULT, BRUSA and SEW, deadtime 0 and 1 with the start
    folded in, both layouts, float64 with its ~95 KB table in both
    deadtimes, a ragged B, T odd batch-major, broadcast scalar leaves,
    angles beyond 2^7); the main case, saturated BRUSA B = 65,536, actions in
    +-0.3, T = 256, through env.fast_rollout in both layouts, one launch each
    and no eager start, final angle or contiguous copy (counted), the
    batch-major slab read in place; the kernel's occupancy; the deviation
    from the exact env.fused_rollout on that fleet and on a holding fleet
    inside the current bands; the kernel alone on the holding fleet and at
    T = 4,096.  Returns the kernel table entry."""
    from exciting_environments_torch.ops.kernels.stepper import build as K_build

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    B, T = B_FAST_CHECK, T_CHECK
    fields = ("i_d", "i_q", "epsilon", "torque", "u_d_buffer", "u_q_buffer", "omega_el")

    def deviation(env, state, acts, time_major=False):
        got = env.fast_rollout(state, acts, time_major=time_major)
        ref = PF.pmsm_fast_rollout(env, state, acts, time_major=time_major)
        torch.cuda.synchronize()
        g = [getattr(got.physical_state, n) for n in fields]
        return max_abs(g, [getattr(ref.physical_state, n) for n in fields]), all(bool(torch.isfinite(x).all()) for x in g)

    cases = [
        ("DEFAULT linear deadtime 1", pmsm_env(ex, B, "DEFAULT", saturated=False), False),
        ("DEFAULT linear deadtime 0 time-major", pmsm_env(ex, B, "DEFAULT", saturated=False, static={"deadtime": 0}),
         True),
        ("BRUSA saturated deadtime 1", pmsm_env(ex, B), False),
        ("BRUSA saturated deadtime 0 time-major", pmsm_env(ex, B, static={"deadtime": 0}), True),
        ("SEW saturated deadtime 1", pmsm_env(ex, B, "SEW"), False),
        ("BRUSA saturated float64 (shared memory above 48 KB)", pmsm_env(ex, B, dtype=torch.float64), False),
        ("BRUSA saturated float64 deadtime 0 time-major", pmsm_env(ex, B, dtype=torch.float64, static={"deadtime": 0}),
         True),
        ("BRUSA saturated ragged B=1000 time-major", pmsm_env(ex, 1000), True),
        ("BRUSA saturated ragged B=1000 batch-major", pmsm_env(ex, 1000), False),
        ("BRUSA saturated batch-major T=63 (odd)", pmsm_env(ex, B), False, 63),
        ("BRUSA saturated broadcast scalar omega_el and epsilon", pmsm_env(ex, B), False, T, "scalar"),
        ("BRUSA saturated angles beyond 2^7", pmsm_env(ex, B), True, T, "wide"),
        ("DEFAULT linear float64 angles beyond 2^7", pmsm_env(ex, B, "DEFAULT", saturated=False,
                                                             dtype=torch.float64), False, T, "wide"),
    ]
    failures = []
    for label, env, time_major, *more in cases:
        n_steps, leaves = (more + [None])[:2] if more else (T, None)
        _, state = env.vmap_reset(rng=gen)
        if leaves == "scalar":
            with ex.core.structures.copy_and_mutate(state) as state:
                state.physical_state.omega_el = torch.tensor(1200.0, device=DEVICE, dtype=env.dtype)
                state.physical_state.epsilon = torch.tensor(-2.5, device=DEVICE, dtype=env.dtype)
        elif leaves == "wide":
            with ex.core.structures.copy_and_mutate(state) as state:
                wide = torch.rand(env.batch_size, generator=gen, device=DEVICE, dtype=torch.float64) * 2 - 1
                state.physical_state.epsilon = (wide * 1e3).to(env.dtype)
        u = torch.rand((n_steps, env.batch_size, 2), generator=gen, device=DEVICE, dtype=torch.float64)
        acts = ((u * 2 - 1) * 0.9).to(env.dtype)
        err, finite = deviation(env, state, acts if time_major else acts.transpose(0, 1).contiguous(), time_major)
        ok = finite and err == 0.0
        log(f"[pmsm fast vs plain] {label}: max abs deviation {err!r} (tolerance 0.0) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"the fast PMSM kernel disagrees with its plain version: {failures}")

    B, T = B_MAIN, T_PMSM
    env = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4, device=DEVICE)
    _, state = env.vmap_reset(rng=gen)
    u = torch.rand((B, T, 2), generator=gen, device=DEVICE, dtype=torch.float64)
    actions = ((u * 2 - 1) * 0.3).float()
    actions_tm = actions.transpose(0, 1).contiguous()
    del u
    # the main path, with the eager start, final angle and copies counted:
    # on the card each layout is one launch and none of them
    launches, finals, eager = {}, {}, {}
    for layout, acts, tm in (("time-major", actions_tm, True), ("batch-major", actions, False)):
        PMK.KERNEL.reset_counts()
        with CallCounter(PMK, "fast_start") as start, CallCounter(PMK, "fast_final_angle") as final, \
                CallCounter(PF, "fast_start") as pf_start, CallCounter(PF, "fast_final_angle") as pf_final, \
                TensorMethodCounter("contiguous") as contiguous:
            finals[layout] = env.fast_rollout(state, acts, time_major=tm)
            torch.cuda.synchronize()
        launches[layout] = PMK.KERNEL.launches["pmsm_fast"]
        eager[layout] = {"fast_start": start.calls + pf_start.calls, "fast_final_angle": final.calls + pf_final.calls,
                         "Tensor.contiguous": contiguous.calls}
        if launches[layout] != 1:
            raise AssertionError(f"env.fast_rollout ({layout}) made {launches[layout]} pmsm_fast launches, not 1")
        if any(eager[layout].values()):
            raise AssertionError(f"env.fast_rollout ({layout}) ran eager work on the card: {eager[layout]}")
    a, b = finals["time-major"].physical_state, finals["batch-major"].physical_state
    if not all(torch.equal(getattr(a, n), getattr(b, n)) for n in fields):
        raise AssertionError("time-major and batch-major fast rollouts disagree")
    if not all(bool(torch.isfinite(getattr(a, n)).all()) and tuple(getattr(a, n).shape) == (B,) for n in fields):
        raise AssertionError("non-finite or misshapen fast PMSM state")
    log(f"[pmsm fast main] PMSM BRUSA saturated B={B} T={T} float32, actions in +-0.3: launches {launches}; "
        f"eager calls {eager}")
    slab_bytes = actions.numel() * actions.element_size()
    extra = extra_memory(lambda: env.fast_rollout(state, actions))
    log(f"[pmsm fast main] batch-major slab read in place: env.fast_rollout batch-major allocated at most {extra} B "
        f"beyond its inputs (slab {slab_bytes} B)")
    if extra >= slab_bytes:
        raise AssertionError("env.fast_rollout copied its batch-major slab")
    occupancy = {"float32": PMK.occupancy(env, torch.float32),
                 "float64": PMK.occupancy(pmsm_env(ex, 128, dtype=torch.float64), torch.float64)}
    log(f"[pmsm fast main] saturated BRUSA deadtime 1, (blocks of 128 threads per SM by "
        f"cudaOccupancyMaxActiveBlocksPerMultiprocessor, dynamic shared memory per block in B): {occupancy}")
    t0 = time.perf_counter()
    ref = PF.pmsm_fast_rollout(env, state, actions_tm, time_major=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs([getattr(a, n) for n in fields], [getattr(ref.physical_state, n) for n in fields])
    if err != 0.0:
        raise AssertionError(f"the fast PMSM kernel disagrees with its plain version at the main size ({err!r})")
    def kernel_args(st, acts, time_major=True):
        """The kernel's own arguments, built as env.fast_rollout builds them."""
        consts, _, lv = PF.fast_inputs(env, st, acts, time_major)
        return env, acts, lv, consts, not time_major

    args = kernel_args(state, actions_tm)
    ms = time_ms(lambda: PMK.kernel_pmsm_fast_rollout(*args))
    ms_chain = time_ms(lambda: PMK.kernel_pmsm_fast_rollout(*args), chain=FAST_CHAIN)
    bm_args = kernel_args(state, actions, False)
    kernel_bm_ms = time_ms(lambda: PMK.kernel_pmsm_fast_rollout(*bm_args), chain=FAST_CHAIN)
    tm_ms = time_ms(lambda: env.fast_rollout(state, actions_tm, time_major=True))
    bm_ms = time_ms(lambda: env.fast_rollout(state, actions))
    tm_chain_ms = time_ms(lambda: env.fast_rollout(state, actions_tm, time_major=True), chain=FAST_CHAIN)
    bm_chain_ms = time_ms(lambda: env.fast_rollout(state, actions), chain=FAST_CHAIN)
    exact_ms = time_ms(lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True))
    bound_ms, bound_by = pmsm_fast_bound(env, B, T)
    steps = B * T
    log(f"[pmsm fast main] kernel alone (one call) {ms!r} ms = {steps / ms * 1e3:.4e} env-steps/s; bound "
        f"{bound_ms!r} ms ({bound_by}); {bound_ms / ms:.1%} of the bound. {FAST_CHAIN} calls back to back: "
        f"{ms_chain!r} ms per call ({bound_ms / ms_chain:.1%} of the bound), batch-major slab {kernel_bm_ms!r} ms")
    log(f"[pmsm fast main] env.fast_rollout time-major {tm_ms!r} ms = {steps / tm_ms * 1e3:.4e} env-steps/s "
        f"(kernel {ms / tm_ms:.1%}), batch-major {bm_ms!r} ms (one call; {FAST_CHAIN} calls back to back: "
        f"{tm_chain_ms!r}, {bm_chain_ms!r} ms per call); the exact env.fused_rollout time-major {exact_ms!r} ms; "
        f"plain version {plain_ms!r} ms (one run)")
    _, kernel_re, vias = sass_case("6")
    anatomy("6 pmsm_fast", K_build("pmsm_fast"), kernel_re, ms, tm_ms, B, T,
            lambda: env.fast_rollout(state, actions_tm, time_major=True), "pmsm_fast_kernel", vias)

    # fast vs exact, max |d i| / max |i|.  float32 over 32 steps at the JAX
    # test's 1e-4.  Over 256 steps most drives of this random fleet run away
    # (currents far outside their bands, the table extrapolated), and the
    # runaway grows every float32 rounding: float64 holds the semantics (the
    # paths agree to rounding), and the float32 fast path stays within 4
    # times the exact path's own float32 distance from float64.
    e, f = exact_and_fast(env, state, actions[:, :32])
    gap32 = current_gap(f, e, current_scale(e))
    e32, f32 = exact_and_fast(env, state, actions)
    env64 = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4, device=DEVICE,
                    dtype=torch.float64)
    state64 = ex.core.structures.map_leaves(
        lambda leaf: leaf.double() if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() else leaf, state)
    e64, f64 = exact_and_fast(env64, state64, actions.double())
    scale = current_scale(e64)
    gap256, fast_drift = current_gap(f32, e32, scale), current_gap(f32, e64, scale)
    exact_drift, gap256_64 = current_gap(e32, e64, scale), current_gap(f64, e64, scale)
    runaway = out_of_band(env64, e64)
    del env64, state64, e, f, e32, f32, e64, f64
    # float32 over 256 steps at 1e-3, on traffic that stays inside the table
    hold_state, hold_actions = holding_fleet(ex, env, gen, T)
    e, f = exact_and_fast(env, hold_state, hold_actions)
    gap_hold, out_hold = current_gap(f, e, current_scale(e)), out_of_band(env, e)
    del e, f
    ok = (gap32 < 1e-4 and gap256_64 < 1e-9 and fast_drift <= 4 * exact_drift
          and gap_hold < 1e-3 and out_hold == 0.0)
    log(f"[pmsm fast main] fast vs exact, max |d i| / max |i|: float32 T=32 {gap32!r} (limit 1e-4); float64 T={T} "
        f"{gap256_64!r} (limit 1e-9); holding fleet float32 T={T} {gap_hold!r} (limit 1e-3, {out_hold:.1%} of it "
        f"out of band, limit 0) {'ok' if ok else 'FAIL'}")
    log(f"[pmsm fast main] random fleet T={T} ({runaway:.1%} of the drives end outside their current bands): "
        f"float32 fast vs float32 exact {gap256!r}; against float64 exact: float32 exact {exact_drift!r}, "
        f"float32 fast {fast_drift!r} (limit 4 x {exact_drift!r})")
    if not ok:
        raise AssertionError("the fast PMSM rollout left its tolerance against the exact path")
    hold_args = kernel_args(hold_state, hold_actions, False)
    hold_ms = time_ms(lambda: PMK.kernel_pmsm_fast_rollout(*hold_args), chain=FAST_CHAIN)
    hold_tm_args = kernel_args(hold_state, hold_actions.transpose(0, 1).contiguous())
    hold_tm_ms = time_ms(lambda: PMK.kernel_pmsm_fast_rollout(*hold_tm_args), chain=FAST_CHAIN)
    log(f"[pmsm fast main] kernel alone on the holding fleet (gathers inside the table), T={T}, {FAST_CHAIN} calls "
        f"back to back: time-major {hold_tm_ms!r} ms, batch-major {hold_ms!r} ms (random fleet {ms_chain!r}, "
        f"{kernel_bm_ms!r} ms)")
    del hold_actions, hold_args, hold_tm_args

    a_long = ((torch.rand((T_PMSM_LONG, B, 2), generator=gen, device=DEVICE) * 2 - 1) * 0.3).contiguous()
    long_args = kernel_args(state, a_long)
    long_ms = time_ms(lambda: PMK.kernel_pmsm_fast_rollout(*long_args), reps=3)
    long_bound, long_by = pmsm_fast_bound(env, B, T_PMSM_LONG)
    log(f"[pmsm fast main] kernel alone, T={T_PMSM_LONG}: {long_ms!r} ms = {B * T_PMSM_LONG / long_ms * 1e3:.4e} "
        f"env-steps/s; bound {long_bound!r} ms ({long_by}); {long_bound / long_ms:.1%} of the bound")
    del a_long, long_args
    return [entry("pmsm_fast", launches["time-major"], err, ms, plain_ms, bound_ms, bound_by,
                  PMSM_FAST_SOURCE, PMSM_FAST_REPLACES)]


# ---------------------------------------------------------------------------
# the five later environments (VanDerPol, FluidTank, Acrobot,
# InductionMachine, EESM) through the stepper and closed-loop kernels, with
# the machines' inverter circle computed in both
# ---------------------------------------------------------------------------

#: a per-batch parameter of each, and its range (tests/test_van_der_pol.py's
#: stiffness sweep, tests/test_induction_machine.py's r_r, tests/test_eesm.py's l_q)
ENV_SWEEPS = {"VanDerPol": ("mu", 0.5, 20.0), "FluidTank": ("c_d", 0.4, 0.8), "Acrobot": ("m_2", 0.5, 1.5),
              "InductionMachine": ("r_r", 1.8, 3.2), "EESM": ("l_q", 3e-3, 6e-3)}
MACHINES = ("InductionMachine", "EESM")
U_DC = 400.0
#: operations of one application of the inverter circle (csrc/classic_envs.cuh::svm_circle: two squares, add,
#: sqrt, clamp, reciprocal, multiply, clamp, two multiplies) and of the tank's post-step clip
SVM_OPS, TANK_CLIP_OPS = 10, 1


def snake(name):
    return re.sub(r"(?<=[a-z])(?=[A-Z])", "_", name).lower()


def new_env(ex, name, batch, dtype=torch.float32, solver="euler", sweep=True, **kwargs):
    """One of the five environments on the card; the machines with ``u_dc``,
    and with ``sweep`` its parameter of ENV_SWEEPS as a per-batch plane."""
    cls = getattr(ex, name)
    if sweep:
        field, lo, hi = ENV_SWEEPS[name]
        kwargs["static_params"] = {**cls._default_static_params(),
                                   field: torch.linspace(lo, hi, batch, device=DEVICE, dtype=torch.float64)}
    if name in MACHINES:
        kwargs.setdefault("u_dc", U_DC)
    return make_env(cls, batch, dtype, solver=solver, **kwargs)


def new_state(env, gen, drain=False):
    """Random states: heights in [0, 3) (with ``drain`` a quarter of the
    tanks nearly empty, below the height that one Euler step of outflow
    overshoots), else the normalized band's inner half of [-2, 2)."""
    lo, hi = (0.0, 3.0) if type(env).__name__ == "FluidTank" else (-2.0, 2.0)
    y0 = [(torch.rand(env.batch_size, generator=gen, device=DEVICE, dtype=torch.float64) * (hi - lo) + lo)
          for _ in env._ode_state_fields]
    if drain:
        y0[0][: env.batch_size // 4] *= 1e-9 / 3.0
    return tuple(y.to(env.dtype) for y in y0)


def new_actions(env, n_rows, gen, drain=False, lim=0.95):
    """Actions in [-lim, lim) (for the machines beyond the inverter circle on
    part of the fleet); with ``drain`` no inflow into the nearly empty tanks."""
    acts = random_actions(env, n_rows, gen, lim)
    if drain:
        acts[:, : env.batch_size // 4] = -1.0
    return acts


def beyond_circle(env, acts):
    """The share of action rows whose physical stator pair lies beyond the
    inverter circle (0 for an environment without one)."""
    from exciting_environments_torch.ops.kernels.stepper import kernel_svm_limit

    lim = kernel_svm_limit(env)
    if not lim:
        return 0.0
    u = env.denormalize_action(acts, env.env_properties)
    return float(((u[..., 0] ** 2 + u[..., 1] ** 2).sqrt() > lim).double().mean())


def phase_env_kernel_vs_plain(ex, K, CL):
    """The five environments through the stepper kernel (step and sim-ahead
    modes) and the closed-loop kernel against their plain versions, B =
    65,536, T = 64, float32 unless stated, tolerance 0.0."""
    from exciting_environments_torch.ops import random as prng
    from exciting_environments_torch.utils.convert import actor_params_from_numpy

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
    B, T = B_MAIN, T_CHECK
    # (label, env, rollout kwargs); "drain": the tank case whose clips fire
    cases = []
    for name, solvers in (("VanDerPol", ("euler", "rk4")), ("FluidTank", ("euler", "heun")),
                          ("Acrobot", ("tsit5", "euler")), ("InductionMachine", ("euler", "rk4")),
                          ("EESM", ("euler", "rk4"))):
        for i, solver in enumerate(solvers):
            # the first solver with the per-batch plane, the second with scalar parameters
            env = new_env(ex, name, B, solver=solver, sweep=i == 0)
            what = f"{snake(name)} {solver}{' per-batch ' + ENV_SWEEPS[name][0] if i == 0 else ''}"
            what += f" u_dc={U_DC:g}" if name in MACHINES else ""
            drain = {"drain": True} if name == "FluidTank" else {}
            cases.append((f"{what} step", env, dict(obs_stride=4, **drain)))
            cases.append((f"{what} sim-ahead ratio 2", env, dict(sim_ahead=True, hold=2, obs_stride=4, **drain)))
    cases += [
        ("acrobot tsit5 fast_math step", new_env(ex, "Acrobot", B, solver="tsit5", fast_math=True), {}),
        ("acrobot rk4 fast_math sim-ahead", new_env(ex, "Acrobot", B, solver="rk4", fast_math=True),
         dict(sim_ahead=True, obs_stride=8)),
        ("eesm rk4 u_dc float64, batch-major slab", new_env(ex, "EESM", 4096 + 77, torch.float64, solver="rk4"),
         dict(obs_stride=4, batch_major=True)),
        ("induction_machine euler u_dc ragged B=1001, batch-major slab (element-wise copies)",
         new_env(ex, "InductionMachine", 1001), dict(batch_major=True)),
        ("eesm euler u_dc ragged B=1001 (three actions, element-wise copies)", new_env(ex, "EESM", 1001), {}),
    ]
    failures = []
    for label, env, kw in cases:
        kw = dict(kw)
        drain = kw.pop("drain", False)
        batch_major = kw.pop("batch_major", False)
        hold = kw.get("hold", 1)
        y0 = new_state(env, gen, drain)
        acts = new_actions(env, T // hold, gen, drain)
        slab = acts.transpose(0, 1).contiguous() if batch_major else acts
        yk, tk = K.kernel_rollout(env, y0, slab, tau=env.tau, batch_major=batch_major, **kw)
        yp, tp = K.plain_rollout(env, y0, acts, tau=env.tau, **kw)
        torch.cuda.synchronize()
        err = max(max_abs(yk, yp), max_abs(tk, tp) if tk is not None else 0.0)
        ok = err == 0.0 and all(bool(torch.isfinite(y).all()) for y in yk)
        extra = ""
        if drain:
            empty = int((yk[0] == 0).sum())
            extra = f"; {empty} tanks empty at the end (the clips fired)"
            ok = ok and (empty > 0 or kw.get("sim_ahead", False))
        if type(env).__name__ in MACHINES:
            extra = f"; {beyond_circle(env, acts):.1%} of the action rows beyond the inverter circle"
        log(f"[envs vs plain] {label}: max abs deviation {err!r} (tolerance 0.0){extra} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)

    # a process-noise slab from the environment: FluidTank, exact mode
    tank = make_env(ex.FluidTank, B, process_noise={"height": 0.5})
    _, state = tank.vmap_reset(prng.split(prng.PRNGKey(SEED, DEVICE), B))
    state.physical_state.height[: B // 4] *= 1e-3  # nearly empty: the clip after the increments fires
    noise_tm, noise_idx = tank._noise_streams(state, T, T)[:2]
    y0 = (state.physical_state.height,)
    acts = new_actions(tank, T, gen)
    yk, _ = K.kernel_rollout(tank, y0, acts, tau=tank.tau, noise_tm=noise_tm, noise_idx=noise_idx)
    yp, _ = K.plain_rollout(tank, y0, acts, tau=tank.tau, noise_tm=noise_tm, noise_idx=noise_idx)
    obs_f, _ = tank.fused_rollout(state, acts, time_major=True, strict=True)
    obs_l, _ = tank.vmap_rollout(state, acts.transpose(0, 1), T)
    torch.cuda.synchronize()
    err, err_l = max_abs(yk, yp), max_abs((obs_f,), (obs_l[:, -1],))
    empty = int((yk[0] == 0).sum())
    ok = err == 0.0 and err_l == 0.0 and float(yk[0].min()) >= 0.0 and empty > 0
    log(f"[envs vs plain] fluid_tank exact-mode process-noise slab (sigma 0.5, a quarter of the tanks nearly "
        f"empty): kernel vs plain {err!r}, fused_rollout vs vmap_rollout {err_l!r} (tolerance 0.0), {empty} tanks "
        f"empty at the end {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("fluid_tank noise slab")

    # the closed loop: affine laws (P/PD tracking one field), the actor on the machine, saves
    im = new_env(ex, "InductionMachine", B, solver="rk4", control_state=["i_sd"])
    actor, ids = ex.make_actor_tile(im)
    weights = actor_params_from_numpy(im, actor_tree(5, n_action=2))
    cl_cases = [
        ("acrobot tsit5 PD", new_env(ex, "Acrobot", B, solver="tsit5", control_state=["theta_1"]),
         ex.AffinePolicy([[-0.9, 0.0, -0.25, 0.0, 0.9]]), {"traj_stride": 1}),
        ("van_der_pol euler PD", new_env(ex, "VanDerPol", B, control_state=["position"]),
         ex.AffinePolicy([[-0.8, -0.3, 0.8]]), {}),
        ("induction_machine rk4 u_dc P on both axes, bias beyond the circle", im,
         ex.AffinePolicy([[-0.9, 0.0, 0.0, 0.0, 0.9], [0.0, -0.9, 0.0, 0.0, 0.0]], b=[0.6, 0.6]),
         {"traj_stride": 1}),
        ("eesm euler u_dc P, three actions", new_env(ex, "EESM", B, control_state=["i_d"]),
         ex.AffinePolicy([[-0.9, 0.0, 0.0, 0.9], [0.0, -0.9, 0.0, 0.0], [0.0, 0.0, -0.5, 0.0]], b=[0.6, 0.6, 0.1]),
         {"traj_stride": 1}),
        ("induction_machine rk4 u_dc actor (16, 16)", im, actor,
         {"traj_stride": 1, "policy_params": weights, "policy_carry": ids}),
        ("induction_machine rk4 u_dc PI obs_stride=4", im,
         ex.AffinePolicy([[-0.9, 0.0, 0.0, 0.0, 0.9], [0.0, -0.9, 0.0, 0.0, 0.0]], b=[0.3, 0.6],
                         Ki=[[-0.02, 0.0, 0.0, 0.0, 0.02], [0.0, -0.02, 0.0, 0.0, 0.0]], clip=1.0),
         {"traj_stride": 4, "policy_carry": tuple(torch.zeros(B, device=DEVICE) for _ in range(2))}),
    ]
    for label, env, policy, kw in cl_cases:
        y0 = new_state(env, gen)
        refs = tuple((torch.rand(env.batch_size, generator=gen, device=DEVICE, dtype=torch.float64) * 2 - 1)
                     .to(env.dtype) for _ in env.control_state)
        err, finite = cl_deviation(CL, env, policy, T, y0, refs, **kw)
        extra = ""
        if kw.get("traj_stride") == 1 and type(env).__name__ in MACHINES:
            out = cl_run(CL, env, policy, T, y0, refs, True, **kw)
            extra = f"; {beyond_circle(env, torch.stack(out[3], dim=-1)):.1%} of the actions beyond the circle"
        ok = finite and err == 0.0
        log(f"[envs closed loop vs plain] {label}: max abs deviation {err!r} (tolerance 0.0){extra} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"the five environments' kernels disagree with their plain versions: {failures}")


def phase_env_golden(ex, K):
    """The Acrobot and FluidTank golden fixtures (10,000 Euler steps) replayed
    in float64 through the stepper kernel, in step mode (``fused_rollout``)
    and in sim-ahead mode (``fused_sim_ahead``), one launch each, checked with
    the fixture tests' own allclose at rtol 1e-16 (tests/envs/test_golden_replay.py,
    tests/envs/test_golden_sim_ahead.py: the sim-ahead angles modulo the wrap)."""
    from exciting_environments_torch.utils import load_sim_properties_from_json

    failures = []
    for name, fixture in (("Acrobot", "acrobot"), ("FluidTank", "fluid_tank")):
        data = ROOT / "tests" / "envs" / fixture / "data"
        params, action_norms, physical_norms, tau = load_sim_properties_from_json(data / "sim_properties.json")
        env = getattr(ex, name)(batch_size=1, tau=tau, solver="euler", static_params=params,
                                physical_normalizations=physical_norms, action_normalizations=action_norms,
                                device=DEVICE, dtype=torch.float64)
        stored = torch.as_tensor(np.load(data / "observations.npy"), device=DEVICE)
        actions = torch.as_tensor(np.load(data / "actions.npy"), device=DEVICE)
        state = env.generate_state_from_observation(stored[0][None], env.env_properties)
        K.KERNEL.reset_counts()
        obs, _ = env.fused_rollout(state, actions[None], obs_stride=1, strict=True)
        step = torch.cat([stored[:1], obs[0]], dim=0)
        obs_sa, _ = env.fused_sim_ahead(state, actions[None], tau, tau, strict=True)
        torch.cuda.synchronize()
        launches = dict(K.KERNEL.launches)
        ok_step = bool(torch.allclose(step, stored, 1e-16))
        diff = obs_sa[0] - stored
        folded = diff - 2.0 * torch.round(diff / 2.0)
        exact = diff.abs() < 1.0
        ok_sa = bool(torch.allclose(folded, torch.zeros_like(folded), 1e-16)) and bool(
            torch.allclose(torch.where(exact, diff, torch.zeros_like(diff)), torch.zeros_like(diff), 1e-16))
        ok = ok_step and ok_sa and launches == {"step": 1, "sim_ahead": 1}
        log(f"[envs golden] {fixture} fixture, {actions.shape[0]} float64 steps: step mode max abs deviation "
            f"{float((step - stored).abs().max())!r}, allclose(rtol=1e-16) {ok_step}; sim-ahead mode max abs "
            f"(modulo the wrap) {float(folded.abs().max())!r}, allclose {ok_sa}; launches {launches} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(fixture)
    if failures:
        raise AssertionError(f"golden replays through the kernel deviate from the fixtures: {failures}")


def phase_env_main(ex, K, CL):
    """The five environments' main cases at full width: ``env.fused_rollout``
    of each (B = 65,536, T = 4,096, float32, Euler at its default tau; the
    machines with u_dc = 400), and one ``env.fused_closed_loop`` per policy
    family: the Acrobot PD law and the induction machine's PI law with u_dc;
    each with the launch count set to 0 just before and read just after,
    kernel vs plain at full size, kernel and entry-point ms, and the bound.
    Returns the kernel table entries."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 32)
    B, T = B_MAIN, T_MAIN
    entries = []
    for name in ("VanDerPol", "FluidTank", "Acrobot", "InductionMachine", "EESM"):
        env = make_env(getattr(ex, name), B, **({"u_dc": U_DC} if name in MACHINES else {}))
        _, state = env.vmap_reset(rng=gen)
        acts = new_actions(env, T, gen)
        slab_gb = acts.numel() * acts.element_size() / 1e9
        K.KERNEL.reset_counts()
        obs, last = env.fused_rollout(state, acts, time_major=True, strict=True)
        torch.cuda.synchronize()
        launches = K.KERNEL.launches["step"]
        if launches != 1 or K.KERNEL.launches["sim_ahead"] != 0:
            raise AssertionError(f"{name}: the main path made {dict(K.KERNEL.launches)} launches, not one")
        if tuple(obs.shape) != (B, len(env.obs_description)) or not bool(torch.isfinite(obs).all()):
            raise AssertionError(f"{name}: unexpected observations {tuple(obs.shape)} or non-finite values")
        y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
        kernel = lambda: K.kernel_rollout(env, y0, acts, tau=env.tau)
        yk, _ = kernel()
        t0 = time.perf_counter()
        yp, _ = K.plain_rollout(env, y0, acts, tau=env.tau)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs(yk, yp)
        err_entry = max_abs(yk, tuple(getattr(last.physical_state, f) for f in env._ode_state_fields))
        if err != 0.0 or err_entry != 0.0:
            raise AssertionError(f"{name}: kernel disagrees with its plain version at the main size ({err!r}, "
                                 f"entry point {err_entry!r})")
        ms = time_ms(kernel)
        entry_ms = time_ms(lambda: env.fused_rollout(state, acts, time_major=True, strict=True))
        bound_ms, bound_by = bound(env, env._solver, B, T, T, 0, False)
        extra = f", {beyond_circle(env, acts[:64]):.1%} of the first 64 rows beyond the inverter circle" \
            if name in MACHINES else ""
        log(f"[envs main] {name} B={B} T={T} tau={env.tau} float32 ({slab_gb:.3f} GB of actions{extra}): "
            f"launches {launches}; kernel {ms!r} ms = {B * T / ms * 1e3:.4e} env-steps/s; env.fused_rollout "
            f"{entry_ms!r} ms (kernel {ms / entry_ms:.1%}); bound {bound_ms!r} ms ({bound_by}, "
            f"{ops_per_step(env, env._solver, False)} operations per step), {bound_ms / ms:.1%} of the bound; "
            f"plain {plain_ms!r} ms (one run); max abs {err!r}")
        entries.append(entry(f"stepper_step_{snake(name)}", launches, err, ms, plain_ms, bound_ms, bound_by, SOURCE,
                             REPLACES))
        del acts, obs, last, yk, yp
        torch.cuda.empty_cache()

    def cl_case(label, env, field, ref, policy, carry):
        _, state = env.vmap_reset(rng=gen)
        setattr(state.reference, field, ref)
        y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
        refs = (getattr(env.env_properties.physical_normalizations, field).normalize(ref),)
        kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs, policy_carry=carry)
        CL.CL_KERNEL.reset_counts()
        out = env.fused_closed_loop(state, policy, T, policy_carry=carry)
        torch.cuda.synchronize()
        launches = CL.CL_KERNEL.launches["closed_loop"]
        obs = out[0]
        if launches != 1 or tuple(obs.shape) != (B, len(env.obs_description)) or not bool(torch.isfinite(obs).all()):
            raise AssertionError(f"{label}: {launches} launches, observations {tuple(obs.shape)}")
        kernel = lambda: CL.kernel_closed_loop(env, y0, policy, T, **kw)
        outk = cl_flat(kernel())
        t0 = time.perf_counter()
        outp = cl_flat(CL.plain_closed_loop(env, y0, policy, T, **kw))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs(outk, outp)
        if err != 0.0:
            raise AssertionError(f"{label}: kernel disagrees with its plain version at the main size ({err!r})")
        ms = time_ms(kernel)
        entry_ms = time_ms(lambda: env.fused_closed_loop(state, policy, T, policy_carry=carry))
        spec = policy.kernel_spec(torch.float32, DEVICE)
        (bound_ms, bound_by), per_step = cl_bound(env, spec, B, T, 0, len(carry or ()), 1)
        log(f"[envs closed loop main] {label} B={B} T={T} tau={env.tau}: launches {launches}; kernel {ms!r} ms = "
            f"{B * T / ms * 1e3:.4e} env-steps/s; env.fused_closed_loop {entry_ms!r} ms (kernel {ms / entry_ms:.1%}); "
            f"bound {bound_ms!r} ms ({bound_by}, {per_step} operations per step), {bound_ms / ms:.1%} of the bound; "
            f"plain {plain_ms!r} ms (one run); mean |ref - {field}| normalized "
            f"{float((obs[:, -1] - obs[:, env._ode_state_fields.index(field)]).abs().mean()):.4f}")
        return launches, err, ms, plain_ms, bound_ms, bound_by

    acro = make_env(ex.Acrobot, B, control_state=["theta_1"])
    got = cl_case("acrobot PD", acro, "theta_1", torch.linspace(-1.5, 1.5, B, device=DEVICE),
                  ex.AffinePolicy([[-0.9, 0.0, -0.25, 0.0, 0.9]]), None)
    entries.append(entry("closed_loop_acrobot_pd", *got, CL_SOURCE, CL_REPLACES))
    im = make_env(ex.InductionMachine, B, control_state=["i_sd"], u_dc=U_DC)
    pi = ex.AffinePolicy([[-0.9, 0.0, 0.0, 0.0, 0.9], [0.0, -0.9, 0.0, 0.0, 0.0]], b=[0.3, 0.6],
                         Ki=[[-0.02, 0.0, 0.0, 0.0, 0.02], [0.0, -0.02, 0.0, 0.0, 0.0]], clip=1.0)
    got = cl_case("induction_machine PI u_dc", im, "i_sd", torch.linspace(-10.0, 10.0, B, device=DEVICE), pi,
                  tuple(torch.zeros(B, device=DEVICE) for _ in range(2)))
    entries.append(entry("closed_loop_induction_machine_pi", *got, CL_SOURCE, CL_REPLACES))
    return entries


# ---------------------------------------------------------------------------
# the machines' drive-control tiles in the closed-loop kernel
# (csrc/foc_laws.cuh)
# ---------------------------------------------------------------------------

#: the tiles' set points: benchmarks/r03/foc_in_kernel_device.py:33-45 and
#: sensorless_foc_in_kernel_device.py:36-55 (IM), tests/test_eesm.py:220-223
FOC_REFS = dict(psi_ref=0.7, torque_ref=8.0)
EESM_REFS = dict(i_d_ref=2.0, i_q_ref=5.0, i_f_ref=4.0)
IM_SENSORS = {"i_sd": 0.3, "i_sq": 0.3}
#: operations of one step of csrc/foc_laws.cuh on the path of a flux above
#: its floor, counted from the source (each add, multiply, division, square
#: root, compare, select, clamp bound and conversion as one): FocLaw::act,
#: the four denormalizations of a tile, and EesmCurrentTile::act
FOC_LAW_OPS, DENORM_OPS, EESM_TILE_OPS = 93, 4, 61
#: the fleet of the tiles' control-quality checks
B_QUALITY = 4096


def tile_policy_ops(spec):
    """Operations of one drive-control tile evaluation (policy ids 4-6),
    counted from csrc/foc_laws.cuh for this spec's flat vector: the
    sensorless observer's innovation of each measured column (one subtract;
    the JAX tile fixes which columns when it is traced, so the functor's
    run-time pick of them is not counted), its non-zero gain, A and B terms
    (a multiply and an add each) and the row sums."""
    from exciting_environments_torch.utils.foc import SensorlessFocPolicy

    if spec.policy_id == 4:
        return FOC_LAW_OPS + 4 * DENORM_OPS
    if spec.policy_id == 6:
        return EESM_TILE_OPS
    flat = spec.flat.double().cpu().numpy()
    at = lambda name: int(flat[SensorlessFocPolicy.SLOTS.index(name)])
    n_terms = sum(bin(at(mask)).count("1") for mask in ("K_MASK", "A_MASK", "B_MASK"))
    return FOC_LAW_OPS + 4 * DENORM_OPS + at("N_MEAS") + 4 + 2 * n_terms + 8


def tile_env(ex, kind, B, gen, dtype=torch.float32, solver="euler", u_dc=None, noise_mode="exact", seed=SEED + 40,
             cold=True, cold_share=None):
    """``(env, state, policy, carry)`` of one drive-control tile: the
    induction machine with ``make_foc_tile`` (kind "foc") or, with 0.3 A
    current sensors, ``make_sensorless_foc_tile`` ("sensorless"), or the EESM
    with ``make_eesm_current_tile`` ("eesm").  ``cold``: zero currents and
    flux; ``cold_share``: a random state with that leading share of the
    fleet cold (both branches of the law's orientation)."""
    extra = {} if u_dc is None else {"u_dc": u_dc}
    if kind == "eesm":
        env = make_env(ex.EESM, B, dtype, solver=solver, **extra)
        policy, carry = ex.make_eesm_current_tile(env, **EESM_REFS)
    else:
        if kind == "sensorless":
            extra.update(observation_noise=IM_SENSORS, noise_mode=noise_mode)
        env = make_env(ex.InductionMachine, B, dtype, solver=solver, **extra)
        make = ex.make_sensorless_foc_tile if kind == "sensorless" else ex.make_foc_tile
        policy, carry = make(env, **FOC_REFS)
    _, state = env.vmap_reset(noise_keys(B, seed)) if env._has_noise else env.vmap_reset(rng=gen)
    phys = state.physical_state
    if cold or cold_share:
        mask = torch.ones(B, dtype=torch.bool, device=DEVICE) if cold else \
            torch.arange(B, device=DEVICE) < int(B * cold_share)
        for f in env._ode_state_fields:
            setattr(phys, f, torch.where(mask, torch.zeros_like(getattr(phys, f)), getattr(phys, f)))
    return env, state, policy, carry


#: the configuration and traffic of the benchmark cell scim-sensorless-foc-fleet-t2048: gym-electric-motor's
#: squirrel-cage machine, each drive at its own speed and torque setpoint
SCIM_CONFIG = ROOT / "portbench" / "configs" / "scim_gem.json"
SCIM_TRAFFIC = ROOT / "portbench" / "traffic" / "foc-operating-points-t2048.json"


def drive_env(ex, kind, B, gen, dtype=torch.float32, solver="euler", noise_mode=None, seed=SEED + 70,
              cold_share=1.0):
    """``(env, state, policy, carry)`` of a fleet whose drives each hold
    their own operating point, on the benchmark cell's machine, law and
    traffic (``SCIM_CONFIG``, ``SCIM_TRAFFIC``): per-drive speed and torque
    setpoint drawn uniformly over the traffic's ranges, ``make_foc_tile``
    (kind "foc") or ``make_sensorless_foc_tile`` ("sensorless", one Kalman
    filter per drive on the configuration's sensor levels; ``noise_mode``:
    the plant's own current sensors at those levels, for a slab).  The
    leading ``cold_share`` of the fleet starts cold, the rest from a random
    reset."""
    cfg, mix = json.loads(SCIM_CONFIG.read_text()), json.loads(SCIM_TRAFFIC.read_text())
    uniform = lambda lo, hi: (lo + (hi - lo) * torch.rand(B, generator=gen, device=DEVICE, dtype=torch.float64))
    omega = uniform(*mix["params"]["omega"]).to(dtype)
    torque = uniform(*mix["setpoints"]["torque"]).to(dtype)
    params = {**ex.InductionMachine._default_static_params(), **cfg["static_params"], "omega": omega}
    bands = {name: ex.MinMaxNormalization(min=lo, max=hi) for name, (lo, hi) in cfg["action_normalizations"].items()}
    kw = {**cfg["kwargs"], "solver": solver}
    if noise_mode is not None:
        kw.update(observation_noise=cfg["sensor_std"], noise_mode=noise_mode)
    env = make_env(ex.InductionMachine, B, dtype, static_params=params, action_normalizations=bands, **kw)
    if kind == "sensorless":
        policy, carry = ex.make_sensorless_foc_tile(env, torque_ref=torque, measurement_std=cfg["sensor_std"],
                                                    **cfg["law"])
    else:
        policy, carry = ex.make_foc_tile(env, torque_ref=torque, **cfg["law"])
    _, state = env.vmap_reset(noise_keys(B, seed)) if env._has_noise else env.vmap_reset(rng=gen)
    phys = state.physical_state
    mask = torch.arange(B, device=DEVICE) < int(B * cold_share)
    for f in env._ode_state_fields:
        setattr(phys, f, torch.where(mask, torch.zeros_like(getattr(phys, f)), getattr(phys, f)))
    return env, state, policy, carry


def phase_foc(ex, K, CL):
    """The machines' drive-control tiles (``utils/foc.py``'s FocPolicy,
    SensorlessFocPolicy and EesmCurrentPolicy, functors of csrc/foc_laws.cuh
    in csrc/closed_loop.cu): kernel against the tile's plain version at
    B = 4,096 and 4,141, T = 64, tolerance 0.0 (float32 and float64, Euler
    and RK4, with and without saves, the EESM with u_dc = 400, the
    sensorless tile on its environment's sensor slab in exact and fast mode
    and on a slab whose flux columns are NaN, a quarter of each fleet
    starting cold); both FOC tiles on per-drive operating points (the
    benchmark cell's machine, law and traffic: ``drive_env``), float32 and
    float64, ragged B, a quarter cold, tolerance 0.0 with one launch of the
    per-drive variant, and again after the setpoints are written in place;
    the refusal of a per-batch static parameter before a launch; the main
    cases at B = 65,536 x T = 4,096, float32, Euler, the default tau, cold
    start (rows 2g-2i): the FOC tile, the sensorless tile on 0.3 A sensors
    (the draws in fast mode; the kernel timed on the pre-drawn slab) and the
    EESM's tile, each one launch through ``env.fused_closed_loop``, kernel
    vs plain at full size, kernel and entry-point ms and the bound; the
    benchmark cell's chunk (the per-drive sensorless tile, B = 65,536 x
    T = 2,048, cold start) likewise; then control quality on the card as the
    JAX tests assert it (B = 4,096): the FOC tile's flux within 5% of 0.7 Vs
    and torque within 5% of 8 Nm after 4,000 steps, the sensorless tile's
    flux within 3%, torque within 5% and belief flux within 5% of the true
    flux after 12,000, the EESM's currents within 2% after 6,000 with every
    action in [-1, 1] and the least torque above 1 Nm.  Returns the kernel
    table entries."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    units = {k: v for k, v in K.BUILD_TIMES.items() if k.startswith("closed_loop/")}
    if units:
        log("[foc] closed-loop units' nvcc seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(units.items())))
    variants = {"foc": "foc", "sensorless": "sensorless_foc", "eesm": "eesm_current"}
    cases = [
        # (label, kind, dtype, solver, B, stride, u_dc, slab): slab "exact"/"fast" the environment's own draws,
        # "nan_flux" a seeded slab over all four columns with NaN in the flux columns
        ("foc euler", "foc", torch.float32, "euler", 4096, None, None, None),
        ("foc rk4, saves every step, ragged B", "foc", torch.float32, "rk4", 4141, 1, None, None),
        ("foc euler float64, saves every 4", "foc", torch.float64, "euler", 4096, 4, None, None),
        ("foc rk4 float64", "foc", torch.float64, "rk4", 4141, None, None, None),
        ("foc euler, u_dc 400, saves every 4", "foc", torch.float32, "euler", 4096, 4, U_DC, None),
        ("sensorless euler, exact-mode slab, saves every step", "sensorless", torch.float32, "euler", 4096, 1, None,
         "exact"),
        ("sensorless rk4, fast-mode slab, ragged B", "sensorless", torch.float32, "rk4", 4141, None, None, "fast"),
        ("sensorless euler float64, exact-mode slab, saves every 4", "sensorless", torch.float64, "euler", 4096, 4,
         None, "exact"),
        ("sensorless rk4 float64, fast-mode slab", "sensorless", torch.float64, "rk4", 4096, None, None, "fast"),
        ("sensorless euler, NaN flux columns", "sensorless", torch.float32, "euler", 4096, 1, None, "nan_flux"),
        ("eesm euler", "eesm", torch.float32, "euler", 4096, None, None, None),
        ("eesm rk4, u_dc 400, saves every step", "eesm", torch.float32, "rk4", 4096, 1, U_DC, None),
        ("eesm rk4 float64, u_dc 400, saves every 4", "eesm", torch.float64, "rk4", 4141, 4, U_DC, None),
        ("eesm euler float64, ragged B", "eesm", torch.float64, "euler", 4141, None, None, None),
    ]
    for i, (label, kind, dtype, solver, B, stride, u_dc, slab) in enumerate(cases):
        env, state, policy, carry = tile_env(ex, kind, B, gen, dtype, solver, u_dc,
                                             noise_mode=slab if slab in ("exact", "fast") else "exact",
                                             seed=SEED + 42 + i, cold=False, cold_share=0.25)
        y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
        kw = dict(traj_stride=stride, policy_carry=carry)
        if slab in ("exact", "fast"):
            kw.update(CL.closed_loop_noise(env, state, T_CHECK, env.env_properties).slabs)
        elif slab == "nan_flux":
            eps = 0.015 * torch.randn((T_CHECK, B, 4), generator=gen, device=DEVICE, dtype=torch.float64)
            eps[..., 2:] = float("nan")
            kw.update(obs_noise_tm=eps.to(dtype), obs_noise_cols=(0, 1, 2, 3))
        variant = variants[kind]
        before, before_v = CL.CL_KERNEL.launches["closed_loop"], CL.VARIANT_LAUNCHES[variant]
        err, finite = cl_deviation(CL, env, policy, T_CHECK, y0, (), **kw)
        launched = (CL.CL_KERNEL.launches["closed_loop"] - before, CL.VARIANT_LAUNCHES[variant] - before_v)
        log(f"[foc kernel vs plain] {label}, B={B} T={T_CHECK}: max abs {err!r}, finite {finite}, "
            f"launches {launched[0]} ({variant} {launched[1]})")
        if err != 0.0 or not finite or launched != (1, 1):
            raise AssertionError(f"{label}: the tile's kernel disagrees with its plain version ({err!r}), "
                                 f"finite {finite}, launches {launched}")

    # per-drive operating points (the benchmark cell's machine, law and traffic): the tile against its plain
    # version, then again after its torque setpoints are written in place, which re-packs the kernel's planes
    drive_cases = [
        # (label, kind, dtype, solver, B, stride, noise mode of a sensor slab)
        ("foc per drive, ragged B", "foc", torch.float32, "euler", 4141, None, None),
        ("foc per drive float64, rk4, saves every 4, ragged B", "foc", torch.float64, "rk4", 4141, 4, None),
        ("sensorless per drive, saves every step, ragged B", "sensorless", torch.float32, "euler", 4141, 1, None),
        ("sensorless per drive float64, ragged B", "sensorless", torch.float64, "euler", 4141, None, None),
        ("sensorless per drive, exact-mode slab, saves every 4", "sensorless", torch.float32, "euler", 4096, 4,
         "exact"),
    ]
    for i, (label, kind, dtype, solver, B, stride, slab) in enumerate(drive_cases):
        env, state, policy, carry = drive_env(ex, kind, B, gen, dtype, solver, noise_mode=slab, seed=SEED + 71 + i,
                                              cold_share=0.25)
        y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
        kw = dict(traj_stride=stride, policy_carry=carry)
        if slab is not None:
            kw.update(CL.closed_loop_noise(env, state, T_CHECK, env.env_properties).slabs)
        variant = variants[kind] + "_per_drive"
        for when in ("built", "setpoints written in place"):
            if when != "built":
                policy.law.torque_ref.mul_(-0.5)
            before, before_v = CL.CL_KERNEL.launches["closed_loop"], CL.VARIANT_LAUNCHES[variant]
            err, finite = cl_deviation(CL, env, policy, T_CHECK, y0, (), **kw)
            launched = (CL.CL_KERNEL.launches["closed_loop"] - before, CL.VARIANT_LAUNCHES[variant] - before_v)
            log(f"[foc kernel vs plain] {label} ({when}), B={B} T={T_CHECK}: max abs {err!r}, finite {finite}, "
                f"launches {launched[0]} ({variant} {launched[1]})")
            if err != 0.0 or not finite or launched != (1, 1):
                raise AssertionError(f"{label} ({when}): the per-drive tile's kernel disagrees with its plain "
                                     f"version ({err!r}), finite {finite}, launches {launched}")

    # the per-drive observer folds all of A but the speed's cross terms, which holds for explicit Euler alone
    try:
        drive_env(ex, "sensorless", 256, gen, solver="rk4")
    except ValueError as e:
        log(f"[foc] a per-drive sensorless tile under rk4 refused when built: {str(e)[:100]}")
    else:
        raise AssertionError("a per-drive sensorless tile under rk4 was built")

    # a tile folded from a per-batch machine parameter runs on the CPU only
    # (a per-batch speed and torque setpoint run per drive in the kernel)
    params = dict(ex.InductionMachine._default_static_params())
    params["l_m"] = np.linspace(0.2, 0.225, 256)
    fleet = make_env(ex.InductionMachine, 256, static_params=params)
    tile, carry = ex.make_foc_tile(fleet, **FOC_REFS)
    _, fstate = fleet.vmap_reset(rng=gen)
    before = CL.CL_KERNEL.launches["closed_loop"]
    try:
        fleet.fused_closed_loop(fstate, tile, 8, policy_carry=carry)
    except ValueError as e:
        log(f"[foc] per-batch l_m refused before a launch: {str(e)[:100]}")
    else:
        raise AssertionError("a FOC tile over a per-batch l_m was not refused on the card")
    if CL.CL_KERNEL.launches["closed_loop"] != before:
        raise AssertionError("the refused tile launched")

    B, T = B_MAIN, T_MAIN
    entries = []
    mains = [("2g", "induction_machine_foc", "foc"), ("2h", "induction_machine_sensorless_foc", "sensorless"),
             ("2i", "eesm_current", "eesm")]
    for row, name, kind in mains:
        env, state, policy, carry = tile_env(ex, kind, B, gen, noise_mode="fast", seed=SEED + 60)
        y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
        CL.CL_KERNEL.reset_counts()
        out = env.fused_closed_loop(state, policy, T, policy_carry=carry)
        torch.cuda.synchronize()
        launches = CL.CL_KERNEL.launches["closed_loop"]
        obs = out[0]
        if launches != 1 or tuple(obs.shape) != (B, len(env.obs_description)) or not bool(torch.isfinite(obs).all()):
            raise AssertionError(f"{name}: {launches} launches, observations {tuple(obs.shape)}")
        noise = CL.closed_loop_noise(env, state, T, env.env_properties) if env._has_noise else None
        slabs = noise.slabs if noise is not None else {}
        kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, policy_carry=carry, **slabs)
        kernel = lambda: CL.kernel_closed_loop(env, y0, policy, T, **kw)
        outk = cl_flat(kernel())
        entry_final = [getattr(out[1].physical_state, f) for f in env._ode_state_fields] + list(out[2])
        t0 = time.perf_counter()
        outp = cl_flat(CL.plain_closed_loop(env, y0, policy, T, **kw))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, err_entry = max_abs(outk, outp), max_abs(outk, entry_final)
        if err != 0.0 or err_entry != 0.0:
            raise AssertionError(f"{name}: kernel disagrees with its plain version at the main size ({err!r}, "
                                 f"entry point {err_entry!r})")
        del outp
        ms = time_ms(kernel)
        if noise is None:
            entry_ms = time_ms(lambda: env.fused_closed_loop(state, policy, T, policy_carry=carry))
            how = "env.fused_closed_loop"
        else:
            _, entry_ms = host_ms(lambda: env.fused_closed_loop(state, policy, T, policy_carry=carry), reps=1)
            bare = {k: v for k, v in kw.items() if k not in slabs}
            bare_ms = time_ms(lambda: CL.kernel_closed_loop(env, y0, policy, T, **bare))
            how = (f"the kernel without the sensor slab {bare_ms!r} ms; env.fused_closed_loop with its fast-mode "
                   "draws (one host-clock run)")
        spec = policy.kernel_spec(torch.float32, DEVICE)
        n_noise = len(slabs.get("obs_noise_cols", ()))
        (bound_ms, bound_by), per_step = cl_bound(env, spec, B, T, 0, len(carry), 0, n_obs_noise=n_noise)
        log(f"[foc main] row {row} {name} B={B} T={T} tau={env.tau} float32, cold start: launches {launches}; "
            f"kernel {ms!r} ms = {B * T / ms * 1e3:.4e} env-steps/s; {how} {entry_ms!r} ms (kernel "
            f"{ms / entry_ms:.1%}); bound {bound_ms!r} ms ({bound_by}, {per_step} operations per step, policy "
            f"{cl_policy_ops(spec, env.action_dim)}), {bound_ms / ms:.1%} of the bound; plain {plain_ms!r} ms "
            f"(one run); max abs {err!r}")
        entries.append(entry(f"closed_loop_{name}", launches, err, ms, plain_ms, bound_ms, bound_by, CL_SOURCE,
                             CL_REPLACES))
        del out, outk, noise, slabs, kw
        torch.cuda.empty_cache()

    # the benchmark cell's chunk: the per-drive sensorless tile over its fleet from a cold start, B = 65,536 x
    # 2,048 steps, float32, Euler
    name, T = "induction_machine_sensorless_foc_per_drive", T_SCIM
    env, state, policy, carry = drive_env(ex, "sensorless", B, gen)
    y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
    CL.CL_KERNEL.reset_counts()
    before_v = CL.VARIANT_LAUNCHES["sensorless_foc_per_drive"]
    out = env.fused_closed_loop(state, policy, T, policy_carry=carry)
    torch.cuda.synchronize()
    launches = (CL.CL_KERNEL.launches["closed_loop"], CL.VARIANT_LAUNCHES["sensorless_foc_per_drive"] - before_v)
    if launches != (1, 1) or not bool(torch.isfinite(out[0]).all()):
        raise AssertionError(f"{name}: launches {launches}, finite {bool(torch.isfinite(out[0]).all())}")
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, policy_carry=carry)
    kernel = lambda: CL.kernel_closed_loop(env, y0, policy, T, **kw)
    outk = cl_flat(kernel())
    entry_final = [getattr(out[1].physical_state, f) for f in env._ode_state_fields] + list(out[2])
    t0 = time.perf_counter()
    outp = cl_flat(CL.plain_closed_loop(env, y0, policy, T, **kw))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, err_entry = max_abs(outk, outp), max_abs(outk, entry_final)
    if err != 0.0 or err_entry != 0.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version at the cell's size ({err!r}, "
                             f"entry point {err_entry!r})")
    del outp
    ms = time_ms(kernel)
    entry_ms = time_ms(lambda: env.fused_closed_loop(state, policy, T, policy_carry=carry))
    spec = policy.kernel_spec(torch.float32, DEVICE)
    (bound_ms, bound_by), per_step = cl_bound(env, spec, B, T, 0, len(carry), 0)
    log(f"[foc main] {name} (the cell scim-sensorless-foc-fleet-t2048's chunk) B={B} T={T} tau={env.tau} float32, "
        f"cold start, {len(spec.planes)} per-drive planes: launches {launches[0]}; kernel {ms!r} ms = "
        f"{B * T / ms * 1e3:.4e} env-steps/s; env.fused_closed_loop {entry_ms!r} ms (kernel {ms / entry_ms:.1%}); "
        f"bound {bound_ms!r} ms ({bound_by}, {per_step} operations per step, policy "
        f"{cl_policy_ops(spec, env.action_dim)}), {bound_ms / ms:.1%} of the bound; plain {plain_ms!r} ms (one "
        f"run); max abs {err!r}")
    entries.append(entry(f"closed_loop_{name}", launches[0], err, ms, plain_ms, bound_ms, bound_by, CL_SOURCE,
                         CL_REPLACES))
    del out, outk
    torch.cuda.empty_cache()

    # control quality on the card (tests/test_foc.py:218-228, :289-310, tests/test_eesm.py:247-265)
    bq = B_QUALITY
    env, state, policy, carry = tile_env(ex, "foc", bq, gen)
    _, last, _ = env.fused_closed_loop(state, policy, 4000, policy_carry=carry)
    phys = last.physical_state
    flux = torch.hypot(phys.psi_rd, phys.psi_rq)
    torque = env.torque(last)
    flux_err, torque_err = float((flux / 0.7 - 1).abs().max()), float((torque / 8.0 - 1).abs().max())
    log(f"[foc quality] FOC tile B={bq} T=4000: flux {float(flux.mean()):.5f} Vs (worst relative error "
        f"{flux_err:.4f}, limit 0.05), torque {float(torque.mean()):.4f} Nm (worst {torque_err:.4f}, limit 0.05)")
    ok = flux_err <= 0.05 and torque_err <= 0.05
    env, state, policy, carry = tile_env(ex, "sensorless", bq, gen, noise_mode="fast", seed=SEED + 61)
    _, last, fcl = env.fused_closed_loop(state, policy, 12000, policy_carry=carry)
    phys = last.physical_state
    flux = torch.hypot(phys.psi_rd, phys.psi_rq)
    belief = torch.hypot(fcl[2] * 1.5, fcl[3] * 1.5)
    torque = env.torque(last)
    errs = (float((flux / 0.7 - 1).abs().max()), float((torque / 8.0 - 1).abs().max()),
            float((belief / flux - 1).abs().max()))
    log(f"[foc quality] sensorless tile, 0.3 A sensors (fast mode), B={bq} T=12000: flux {float(flux.mean()):.5f} "
        f"Vs (worst {errs[0]:.4f}, limit 0.03), torque {float(torque.mean()):.4f} Nm (worst {errs[1]:.4f}, limit "
        f"0.05), belief flux against the true flux worst {errs[2]:.4f} (limit 0.05)")
    ok = ok and errs[0] <= 0.03 and errs[1] <= 0.05 and errs[2] <= 0.05
    env, state, policy, carry = tile_env(ex, "eesm", bq, gen, cold=False)
    _, acts, last, _ = env.fused_closed_loop(state, policy, 6000, obs_stride=1, policy_carry=carry)
    phys = last.physical_state
    cur = {f: float((getattr(phys, f) / EESM_REFS[f"{f}_ref"] - 1).abs().max()) for f in ("i_d", "i_q", "i_f")}
    act_max, torque_min = float(acts.abs().max()), float(env.torque(last).min())
    log(f"[foc quality] EESM tile B={bq} T=6000 from a random reset: worst relative current errors {cur} (limit "
        f"0.02), largest |action| {act_max!r}, least torque {torque_min:.4f} Nm (above 1)")
    # |a| <= 1 up to the float32 rounding of u_max * (1 / u_max) on the clamp
    one_ulp_above = float(np.nextafter(np.float32(1.0), np.float32(2.0)))
    ok = (ok and max(cur.values()) <= 0.02 and act_max <= one_ulp_above and torque_min > 1.0
          and bool(torch.isfinite(acts).all()))
    if not ok:
        raise AssertionError("a drive-control tile missed its control-quality checks on the card")
    return entries


# ---------------------------------------------------------------------------
# stochastic simulation: draw streams, noisy main paths, slabs from the
# environment into every exact kernel
# ---------------------------------------------------------------------------

#: tests/test_noise.py's levels: the pendulum's (:27, :203-204) and the drive's (:481-482)
NOISE_PENDULUM = dict(process_noise={"omega": 0.5}, observation_noise={"theta": 0.02})
NOISE_BRUSA = dict(process_noise={"i_d": 2.0, "i_q": 2.0}, observation_noise={"i_d": 0.5, "i_q": 0.5, "torque": 0.2})
#: (mode, T, obs_stride) of the noisy pendulum main path
NOISE_PENDULUM_RUNS = (("exact", 256, 16), ("fast", 4096, 64))
#: the largest deviation of a normal drawn on the card from the same draw on
#: the CPU, in ulps of max(|x|, 1): erfinv is the only operation that differs
NORMAL_ULPS = 64


def host_ms(fn, reps=3):
    """Median host time of ``fn`` over ``reps`` runs, each ended by a
    synchronize (for eager sequences of many launches)."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def ulps(card, cpu):
    """The largest deviation of ``card`` from ``cpu`` in ulps of max(|x|, 1)."""
    ref = cpu.abs().clamp_min(1.0)
    ulp = torch.nextafter(ref, torch.full_like(ref, float("inf"))) - ref
    return float(((card.cpu() - cpu).abs() / ulp).max())


def noise_keys(B, seed):
    from exciting_environments_torch.ops import random as R

    return R.split(R.PRNGKey(seed, device=DEVICE), B)


def phase_draws(ex):
    """The threefry streams on the card against the same streams on the
    CPU at B = 65,536: keys, ``split``/``fold_in`` chains, the exact chain's
    and the fast mode's slab keys bit for bit, uniforms bit for bit, normals
    within NORMAL_ULPS, and the process increments' sample std within 1% of
    sigma * sqrt(tau)."""
    from exciting_environments_torch.ops import random as R

    B = B_MAIN
    keys, keys_cpu = noise_keys(B, SEED), R.split(R.PRNGKey(SEED, device="cpu"), B)
    k, kc = keys, keys_cpu
    for t in range(32):
        k, kc = R.fold_in(R.split(k, 3)[:, t % 3], t), R.fold_in(R.split(kc, 3)[:, t % 3], t)
    bitwise = torch.equal(keys.cpu(), keys_cpu) and torch.equal(k.cpu(), kc)
    uni = all(torch.equal(R.uniform(keys, 4, dt, -1.0, 1.0).cpu(), R.uniform(keys_cpu, 4, dt, -1.0, 1.0))
              for dt in (torch.float32, torch.float64))
    n_ulps = {str(dt): ulps(R.normal(keys, 4, dt), R.normal(keys_cpu, 4, dt)) for dt in (torch.float32, torch.float64)}
    slab_keys, slab_ulps, stds = True, {}, {}
    for mode in ("exact", "fast"):
        env = make_env(ex.Pendulum, B, tau=1e-4, noise_mode=mode, **NOISE_PENDULUM)
        env_cpu = ex.Pendulum(batch_size=B, tau=1e-4, noise_mode=mode, device="cpu", **NOISE_PENDULUM)
        env_cpu._fast_chunk_elems = 1 << 22  # keeps the CPU's temporaries small
        card = env._noise_slabs(keys, T_CHECK, 16)
        cpu = env_cpu._noise_slabs(keys_cpu, T_CHECK, 16)
        slab_keys &= torch.equal(card[2].cpu(), cpu[2]) and torch.equal(card[3].cpu(), cpu[3])
        slab_ulps[mode] = max(ulps(card[0], cpu[0]), ulps(card[1], cpu[1]))
        noise_tm, _ = env._process_noise_slab(card[0])
        stds[mode] = float(noise_tm.double().std()) / (0.5 * math.sqrt(env.tau))
    log(f"[draws] B={B}: keys and 32 split/fold_in links bitwise {bitwise}; uniforms bitwise {uni}; normals "
        f"within {n_ulps} ulps of max(|x|, 1) of the CPU's; exact and fast slabs (T={T_CHECK}, stride 16): keys "
        f"bitwise {slab_keys}, draws within {slab_ulps} ulps; process increments' sample std over sigma sqrt(tau): "
        f"{stds}")
    if not (bitwise and uni and slab_keys):
        raise AssertionError("a threefry stream on the card differs from the CPU's")
    if max(list(n_ulps.values()) + list(slab_ulps.values())) > NORMAL_ULPS:
        raise AssertionError(f"normals on the card beyond {NORMAL_ULPS} ulps of the CPU's")
    if any(abs(v - 1.0) > 0.01 for v in stds.values()):
        raise AssertionError(f"process increments' std off sigma sqrt(tau) by more than 1%: {stds}")


def phase_noise_pendulum(ex, K):
    """The noisy pendulum main path (B = 65,536, tau = 1e-4, float32): exact
    mode over T = 256 with saves every 16, fast mode over T = 4,096 with
    saves every 64.  ``env.fused_rollout`` with the count set to 0 just
    before and read just after (one launch), against the eager
    ``vmap_rollout`` from the same keys; the kernel against its plain version
    on the same slab (0.0); the draw pre-pass, the kernel and the entry point
    timed, the pre-pass's peak memory.  Returns the kernel table entries."""
    B = B_MAIN
    entries = []
    for mode, T, stride in NOISE_PENDULUM_RUNS:
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 30)
        env = make_env(ex.Pendulum, B, tau=1e-4, noise_mode=mode, **NOISE_PENDULUM)
        _, state = env.vmap_reset(noise_keys(B, SEED + 30))
        acts = random_actions(env, T, gen).transpose(0, 1).contiguous()  # batch-major, as users pass it
        K.KERNEL.reset_counts()
        obs, last = env.fused_rollout(state, acts, obs_stride=stride, strict=True)
        torch.cuda.synchronize()
        launches = K.KERNEL.launches["step"]
        if launches != 1 or tuple(obs.shape) != (B, T // stride, 2) or not bool(torch.isfinite(obs).all()):
            raise AssertionError(f"noisy pendulum {mode}: {launches} launches, shape {tuple(obs.shape)}")
        (obs_r, last_r), loop_ms = host_ms(lambda: env.vmap_rollout(state, acts, stride), reps=1)
        err_loop = max_abs([obs, last.physical_state.omega], [obs_r, last_r.physical_state.omega])
        if not torch.equal(last.PRNGKey, last_r.PRNGKey) or err_loop > 1e-5:
            raise AssertionError(f"noisy pendulum {mode}: fused_rollout and vmap_rollout disagree ({err_loop!r})")
        streams, pre_ms = host_ms(lambda: env._noise_streams(state, T, stride))
        pre_mem = extra_memory(lambda: env._noise_streams(state, T, stride))
        noise_tm, noise_idx = streams[0], streams[1]
        y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
        kw = dict(tau=env.tau, obs_stride=stride, noise_tm=noise_tm, noise_idx=noise_idx)
        acts_tm = acts.transpose(0, 1).contiguous()
        kernel = lambda: K.kernel_rollout(env, y0, acts_tm, **kw)
        outk = kernel()
        (outp, plain_ms) = host_ms(lambda: K.plain_rollout(env, y0, acts_tm, **kw), reps=1)
        err = max_abs([*outk[0], *outk[1]], [*outp[0], *outp[1]])
        if err != 0.0:
            raise AssertionError(f"noisy pendulum {mode}: kernel disagrees with its plain version ({err!r})")
        ms = time_ms(kernel)
        _, env_ms = host_ms(lambda: env.fused_rollout(state, acts, obs_stride=stride, strict=True))
        n, n_p, n_saves = len(env._ode_state_fields), noise_tm.shape[-1], T // stride
        nbytes = 4 * (T * B * (env.action_dim + n_p) + 2 * n * B + n_saves * n * B)
        ops = (ops_per_step(env, env._solver, False) + n_p + 5 * len(env._angle_fields)) * B * T
        bound_ms, bound_by = roofline(nbytes, ops)
        log(f"[noise pendulum] {mode} B={B} T={T} stride {stride}: draw pre-pass {pre_ms!r} ms "
            f"({pre_ms / T!r} ms per step, peak {pre_mem / 1e9:.3f} GB), kernel {ms!r} ms (bound {bound_ms!r} ms, "
            f"{bound_by}; {bound_ms / ms:.1%}), env.fused_rollout {env_ms!r} ms (kernel {ms / env_ms:.1%}, "
            f"pre-pass {pre_ms / env_ms:.1%}), vmap_rollout {loop_ms!r} ms (one run), plain {plain_ms!r} ms; "
            f"launches {launches}; kernel vs plain {err!r}, fused_rollout vs vmap_rollout {err_loop!r}")
        entries.append(entry(f"step_noise_{mode}", launches, err, ms, plain_ms, bound_ms, bound_by, SOURCE, REPLACES))
        del noise_tm, streams, outk, outp
    return entries


#: (dtype, solver, saturated, deadtime, obs_stride, noise mode) of the PMSM slab against its plain version
PMSM_NOISE_CASES = [
    (torch.float32, "euler", True, 1, None, "exact"),
    (torch.float32, "euler", True, 0, 16, "fast"),
    (torch.float32, "rk4", True, 1, 16, "exact"),
    (torch.float32, "euler", False, 0, None, "exact"),
    (torch.float32, "rk4", False, 1, 16, "fast"),
    (torch.float64, "euler", True, 1, 16, "exact"),
    (torch.float64, "rk4", True, 0, None, "fast"),
    (torch.float64, "euler", False, 1, 16, "exact"),
]


def phase_noise_pmsm(ex, PK):
    """The drive kernel's process-noise slab: every case of PMSM_NOISE_CASES
    (B = 65,536, T = 64) against the plain version on the environment's own
    slab at 0.0, the angle, buffer and last-voltage outputs equal to the
    noiseless run's; then the noisy saturated BRUSA main path (B = 65,536,
    T = 256, float32, both modes, deadtime 0 and 1): one launch per
    ``env.fused_rollout``, its agreement with ``vmap_rollout`` from the same
    keys, the kernel against its plain version, the pre-pass, kernel and
    entry-point times.  Returns the kernel table entries."""
    B = B_MAIN
    worst = 0.0
    for dtype, solver, saturated, deadtime, stride, mode in PMSM_NOISE_CASES:
        env = pmsm_env(ex, B, "BRUSA", saturated, dtype, static={"deadtime": deadtime}, solver=solver,
                       noise_mode=mode, **NOISE_BRUSA)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
        _, state = env.vmap_reset(noise_keys(B, SEED + 31))
        acts = ((torch.rand((T_CHECK, B, 2), generator=gen, device=DEVICE, dtype=torch.float64) * 2 - 1)
                * 0.9).to(dtype)
        noise_tm, noise_idx, *_ = env._noise_streams(state, T_CHECK, stride or T_CHECK)
        kw = dict(obs_stride=stride, noise_tm=noise_tm, noise_idx=noise_idx)
        err, finite = pmsm_deviation(PK, env, state, acts, **kw)
        quiet = pmsm_run(PK, env, state, acts, True, obs_stride=stride)
        noisy = pmsm_run(PK, env, state, acts, True, **kw)
        same = all(torch.equal(noisy[i], quiet[i]) for i in (3, 4, 5, 6, 7))
        moved = not torch.equal(noisy[0], quiet[0])
        log(f"[pmsm noise] {str(dtype)[6:]} {solver} {'saturated' if saturated else 'linear'} deadtime {deadtime} "
            f"stride {stride} {mode}: kernel vs plain max abs {err!r}; angle, buffers and last voltage as without "
            f"noise {same}; currents moved {moved}")
        if err != 0.0 or not finite or not same or not moved:
            raise AssertionError("the PMSM noise slab disagrees with its plain version")
        worst = max(worst, err)

    entries = []
    for mode, deadtime in (("exact", 1), ("fast", 0)):
        env = pmsm_env(ex, B, static={"deadtime": deadtime}, noise_mode=mode, **NOISE_BRUSA)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 32)
        _, state = env.vmap_reset(noise_keys(B, SEED + 32))
        acts = ((torch.rand((B, T_PMSM, 2), generator=gen, device=DEVICE) * 2 - 1) * 0.3).contiguous()
        stride = 16
        PK.KERNEL.reset_counts()
        obs, last = env.fused_rollout(state, acts, obs_stride=stride, strict=True)
        torch.cuda.synchronize()
        launches = PK.KERNEL.launches["pmsm_step"]
        if launches != 1 or tuple(obs.shape) != (B, T_PMSM // stride, 8) or not bool(torch.isfinite(obs).all()):
            raise AssertionError(f"noisy BRUSA {mode}: {launches} launches, shape {tuple(obs.shape)}")
        (obs_r, last_r), loop_ms = host_ms(lambda: env.vmap_rollout(state, acts, stride), reps=1)
        err_loop = max_abs([obs], [obs_r])
        if not torch.equal(last.PRNGKey, last_r.PRNGKey) or err_loop > 1e-4:
            raise AssertionError(f"noisy BRUSA {mode}: fused_rollout and vmap_rollout disagree ({err_loop!r})")
        streams, pre_ms = host_ms(lambda: env._noise_streams(state, T_PMSM, stride))
        noise_tm, noise_idx = streams[0], streams[1]
        acts_tm = acts.transpose(0, 1).contiguous()
        kw = dict(obs_stride=stride, noise_tm=noise_tm, noise_idx=noise_idx)
        err, _ = pmsm_deviation(PK, env, state, acts_tm, **kw)
        if err != 0.0:
            raise AssertionError(f"noisy BRUSA {mode}: kernel disagrees with its plain version ({err!r})")
        _, plain_ms = host_ms(lambda: pmsm_run(PK, env, state, acts_tm, False, **kw), reps=1)
        ms = time_ms(lambda: pmsm_run(PK, env, state, acts_tm, True, **kw))
        quiet_ms = time_ms(lambda: pmsm_run(PK, env, state, acts_tm, True, obs_stride=stride))
        _, env_ms = host_ms(lambda: env.fused_rollout(state, acts, obs_stride=stride, strict=True))
        bound_ms, bound_by = pmsm_bound(env, env._solver, B, T_PMSM, T_PMSM // stride, n_noise=len(noise_idx))
        log(f"[pmsm noise main] BRUSA {mode} deadtime {deadtime} B={B} T={T_PMSM} stride {stride}: draw pre-pass "
            f"{pre_ms!r} ms ({pre_ms / T_PMSM!r} ms per step), kernel {ms!r} ms (without the slab {quiet_ms!r} ms; "
            f"bound {bound_ms!r} ms, {bound_by}; {bound_ms / ms:.1%}), env.fused_rollout {env_ms!r} ms (kernel "
            f"{ms / env_ms:.1%}), vmap_rollout {loop_ms!r} ms (one run), plain {plain_ms!r} ms; launches {launches}; "
            f"kernel vs plain {err!r}, fused_rollout vs vmap_rollout {err_loop!r}")
        entries.append(entry(f"pmsm_step_noise_{mode}", launches, err, ms, plain_ms, bound_ms, bound_by, PMSM_SOURCE,
                             PMSM_REPLACES))
        del noise_tm, streams
    return entries


#: the noisy closed loops' horizon, cut from T_MAIN (4,096) to keep the
#: script's phases under ~700 s (BRUSA runs half of it)
T_NOISE_CL = 2048


def phase_noise_closed_loops(ex, CL, PCL):
    """The closed loops on the environment's own slabs: the noisy tracking
    pendulum with the PD and the PI law over ``T_NOISE_CL`` = 2,048 (fast
    mode), the exploring actor collected over T = 64 (exact mode, tau =
    2e-2) and the noisy saturated BRUSA with the PI law over 1,024 (fast
    mode), all at
    B = 65,536: one launch per entry-point call, and the kernel against its
    plain version on the slabs the entry point streams (0.0)."""
    from exciting_environments_torch.utils.convert import actor_params_from_numpy

    B = B_MAIN
    results = []

    def pendulum(mode, tau=1e-4, seed=SEED + 33):
        env = make_env(ex.Pendulum, B, tau=tau, control_state=["theta"], noise_mode=mode,
                       process_noise={"omega": 0.5}, observation_noise={"theta": 0.02, "omega": 0.05})
        _, state = env.vmap_reset(noise_keys(B, seed))
        state.reference.theta = torch.linspace(-1.5, 1.5, B, device=DEVICE)
        y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
        refs = (env.env_properties.physical_normalizations.theta.normalize(state.reference.theta),)
        return env, state, y0, refs

    def case(name, lib, mode_name, drive, run, n_steps):
        lib.reset_counts()
        obs = drive()
        torch.cuda.synchronize()
        launches = lib.launches[mode_name]
        if launches != 1 or not bool(torch.isfinite(obs).all()):
            raise AssertionError(f"{name}: {launches} launches, finite observations {bool(torch.isfinite(obs).all())}")
        outk, outp = cl_flat(run(True)), cl_flat(run(False))
        torch.cuda.synchronize()
        err = max_abs(outk, outp)
        ms = time_ms(lambda: run(True), reps=3)
        _, env_ms = host_ms(drive, reps=1)
        log(f"[noise closed loop] {name} B={B} T={n_steps}: launches {launches}, kernel vs plain on the "
            f"environment's slabs {err!r}, kernel {ms!r} ms, entry point with its draws {env_ms!r} ms (one run)")
        if err != 0.0:
            raise AssertionError(f"{name}: kernel disagrees with its plain version on the environment's slabs")
        results.append((name, err))

    env, state, y0, refs = pendulum("fast")
    pd, pi = ex.AffinePolicy(PD_GAINS), ex.AffinePolicy(**PI_LAW)
    c0 = (torch.zeros(B, device=DEVICE),)
    noise = CL.closed_loop_noise(env, state, T_NOISE_CL, env.env_properties)
    for name, policy, carry in (("pendulum PD", pd, None), ("pendulum PI", pi, c0)):
        extra = {} if carry is None else {"policy_carry": carry}
        case(name, CL.CL_KERNEL, "closed_loop",
             lambda: env.fused_closed_loop(state, policy, T_NOISE_CL, **extra)[0],
             lambda k: cl_run(CL, env, policy, T_NOISE_CL, y0, refs, k, **noise.slabs, **extra), T_NOISE_CL)
    del noise

    rl_env, rl_state, rl_y0, rl_refs = pendulum("exact", tau=2e-2, seed=SEED + 34)
    actor, ids = ex.make_actor_tile(rl_env)
    weights = actor_params_from_numpy(rl_env, actor_tree(3))
    collector = ex.RolloutCollector(rl_env)
    noise = CL.closed_loop_noise(rl_env, rl_state, T_CHECK, rl_env.env_properties)
    rl_kw = dict(traj_stride=1, policy_params=weights, policy_carry=ids, **noise.slabs)
    case("actor collection", CL.CL_KERNEL, "closed_loop",
         lambda: collector.collect_policy_fused(actor, rl_state, T_CHECK, policy_params=weights,
                                                policy_carry=ids)[0].observations,
         lambda k: cl_run(CL, rl_env, actor, T_CHECK, rl_y0, rl_refs, k, **rl_kw), T_CHECK)

    drive = pmsm_env(ex, B, control_state=["i_d", "i_q"], noise_mode="fast", **NOISE_BRUSA)
    _, dstate = drive.vmap_reset(noise_keys(B, SEED + 35))
    dstate.reference.i_d = torch.linspace(-200.0, -10.0, B, device=DEVICE)
    dstate.reference.i_q = torch.linspace(-150.0, 150.0, B, device=DEVICE)
    pn = drive.env_properties.physical_normalizations
    drefs = (pn.i_d.normalize(dstate.reference.i_d), pn.i_q.normalize(dstate.reference.i_q))
    phys = dstate.physical_state
    state0 = (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
    omega = phys.omega_el
    law = ex.AffinePolicy(PCL_P, Ki=PCL_KI)
    dc0 = (torch.zeros(B, device=DEVICE), torch.zeros(B, device=DEVICE))
    T_D = T_NOISE_CL // 2
    noise = CL.closed_loop_noise(drive, dstate, T_D, drive.env_properties)
    dkw = dict(ref_leaves=drefs, policy_carry=dc0, **noise.slabs)
    case("BRUSA PI", PCL.PMSM_CL_KERNEL, "pmsm_closed_loop",
         lambda: drive.fused_closed_loop(dstate, law, T_D, policy_carry=dc0)[0],
         lambda k: pcl_run(PCL, drive, law, T_D, state0, omega, k, **dkw), T_D)
    return results


# ---------------------------------------------------------------------------
# gradient phases: the four exact kernels' VJPs, and controller training
# ---------------------------------------------------------------------------

#: the gradient limit, max abs deviation over the reference gradient's max abs
GRAD_LIMIT = {torch.float32: 1e-5, torch.float64: 1e-12}
B_GRAD, T_GRAD = 4096, 16


def flat_tensors(out):
    """The tensors of a nest of tuples, ``None`` dropped."""
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for part in out for t in flat_tensors(part)]


def grad_case(run_vjp, run_plain, inputs, lib, mode, seed):
    """One VJP case on the card: the forward through the kernel (one launch
    with checkpoint saves) and the checkpointed replay, against autograd
    through the plain loop on the same inputs, with a linear loss that
    weights every output by seeded weights over its scale.  Returns the
    gradient deviation (max abs over the reference's max abs, worst input),
    the forward outputs' max abs deviation, the VJP forward's launches, and
    its forward and backward ms (host clock, synchronized)."""
    torch.cuda.synchronize()
    before = lib.launches[mode]
    t0 = time.perf_counter()
    out_k = flat_tensors(run_vjp())
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    launches = lib.launches[mode] - before
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    weights = [torch.rand(t.shape, generator=gen, device=DEVICE, dtype=torch.float64).to(t.dtype)
               / (1 + float(t.detach().abs().max())) for t in out_k]
    t0 = time.perf_counter()
    g_k = torch.autograd.grad(sum((t * w).sum() for t, w in zip(out_k, weights)), inputs)
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t0) * 1e3
    out_p = flat_tensors(run_plain())
    g_p = torch.autograd.grad(sum((t * w).sum() for t, w in zip(out_p, weights)), inputs)
    if len(out_k) != len(out_p) or any(k.shape != q.shape for k, q in zip(out_k, out_p)):
        raise AssertionError("the VJP and the plain loop return different structures")
    fwd_err = max_abs([t.detach() for t in out_k], [t.detach() for t in out_p])
    dev = 0.0
    for a, b in zip(g_k, g_p):
        scale = float(b.abs().max())
        if not (scale > 0 and bool(torch.isfinite(a).all())):
            raise AssertionError("a reference gradient is zero, or a gradient is not finite")
        dev = max(dev, float((a - b).abs().max()) / scale)
    return dev, fwd_err, launches, fwd_ms, bwd_ms


def leaf(t):
    return t.detach().clone().requires_grad_(True)


def grad_inputs_stepper(ex, K, name, dtype, gen, batch, n_steps, stride=None, solver="euler", sim_ahead=False,
                        hold=1, noise=False, per_batch=False, batch_major=False):
    extra = {}
    if per_batch:
        extra = dict(static_params={"l": 1.0 + torch.rand(batch, generator=gen, device=DEVICE), "m": 1.0, "g": 9.81},
                     action_normalizations={"torque": ex.MinMaxNormalization(
                         min=-20.0, max=15.0 + 10 * torch.rand(batch, generator=gen, device=DEVICE))})
    env = make_env(getattr(ex, name), batch, dtype, solver=solver, **extra)
    props = env.env_properties
    pt = [leaf(t) for t in K.ck.prop_tensors(props)]
    props = K.ck.props_with(props, pt)
    y0 = tuple(leaf(t) for t in random_state(env, gen))
    acts = leaf(random_actions(env, n_steps // hold, gen))
    nz = leaf(0.05 * torch.randn((n_steps, batch, 1), generator=gen, device=DEVICE, dtype=dtype)) if noise else None
    kw = dict(tau=env.tau, props=props, obs_stride=stride, sim_ahead=sim_ahead, hold=hold, noise_tm=nz,
              noise_idx=(1,) if noise else ())
    slab = acts.transpose(0, 1).contiguous() if batch_major else acts
    slab = leaf(slab)
    tm = slab.transpose(0, 1) if batch_major else slab
    run_k = lambda: K.kernel_rollout(env, y0, slab, batch_major=batch_major, **kw)
    run_p = lambda: K.plain_rollout(env, y0, tm, **kw)
    inputs = [*y0, slab, *pt] + ([nz] if noise else [])
    return run_k, run_p, inputs, K.KERNEL, "sim_ahead" if sim_ahead else "step"


def grad_inputs_cl(ex, CL, name, dtype, gen, batch, n_steps, stride=None, solver="euler", pi=False, noise=False,
                   per_batch=False, actor=False, u_dc=None, bias=0.0, foc_tile=False):
    from exciting_environments_torch.utils.convert import actor_params_from_numpy

    control = [{"Pendulum": "theta", "CartPole": "deflection", "InductionMachine": "i_sd"}[name]]
    extra = dict(static_params={"l": 1.0 + torch.rand(batch, generator=gen, device=DEVICE), "m": 1.0,
                                "g": 9.81}) if per_batch else {}
    if u_dc is not None:
        extra["u_dc"] = u_dc
    env = make_env(getattr(ex, name), batch, dtype, solver=solver, control_state=control, **extra)
    props = env.env_properties
    pt = [leaf(t) for t in CL.ck.prop_tensors(props)]
    props = CL.ck.props_with(props, pt)
    n = len(env._ode_state_fields)
    y0 = tuple(leaf(t) for t in random_state(env, gen))
    refs = (random_state(env, gen)[0] * 0.8,)
    refs = refs if foc_tile else tuple(leaf(r) for r in refs)  # the FOC tile does not read the reference
    carry = None
    if foc_tile:
        # the induction machine's FOC tile: no policy parameters; the
        # gradient in the state, the reference and the integrator planes
        policy, carry = ex.make_foc_tile(env, **FOC_REFS)
        carry = tuple(leaf(c) if i < 3 else c for i, c in enumerate(carry))
        params, grads_of = None, list(carry[:3])
    elif actor:
        policy, carry = ex.make_actor_tile(env, deterministic=True)
        tree = actor_params_from_numpy(env, actor_tree(n + 1))
        params = {"actor": [{k: leaf(v) for k, v in layer.items()} for layer in tree["actor"]],
                  "log_std": tree["log_std"], "seed": tree["seed"]}
        grads_of = [t for layer in params["actor"] for t in layer.values()]
    else:
        # the first action's law over the state and the reference, each
        # further action's a P law on its own state column
        a = env.action_dim
        K0 = [[-0.9, -0.25] + [0.3] * (n - 2) + [0.9]] + [[0.0] * j + [-0.9] + [0.0] * (n - j) for j in range(1, a)]
        Ki = [[-0.02] + [0.0] * (n - 1) + [0.02]] + [[0.0] * j + [-0.02] + [0.0] * (n - j) for j in range(1, a)]
        policy = ex.AffinePolicy(K0, b=[bias] * a, Ki=Ki if pi else None)
        params = leaf(policy.flat_params().to(device=DEVICE, dtype=dtype))
        grads_of = [params]
        if pi:
            carry = tuple(leaf(0.1 * random_state(env, gen)[0]) for _ in range(a))
            grads_of += list(carry)
    on = leaf(0.02 * torch.randn((n_steps, batch, 2), generator=gen, device=DEVICE, dtype=dtype)) if noise else None
    pn = leaf(0.02 * torch.randn((n_steps, batch, 1), generator=gen, device=DEVICE, dtype=dtype)) if noise else None
    kw = dict(tau=env.tau, solver=env._solver, props=props, ref_leaves=refs, traj_stride=stride,
              policy_params=params, policy_carry=carry, obs_noise_tm=on, proc_noise_tm=pn,
              obs_noise_cols=(0, n) if noise else (), proc_noise_idx=(1,) if noise else ())
    run_k = lambda: CL.kernel_closed_loop(env, y0, policy, n_steps, **kw)
    run_p = lambda: CL.plain_closed_loop(env, y0, policy, n_steps, **kw)
    inputs = [*y0, *(() if foc_tile else refs), *grads_of, *pt] + ([on, pn] if noise else [])
    return run_k, run_p, inputs, CL.CL_KERNEL, "closed_loop"


def pmsm_grad_state(env, gen, batch, dtype, lim_i=0.3):
    """Start currents inside the inner ``lim_i`` of the bands, random angles,
    speeds up to 30% of the band and buffers of a few tens of volts."""
    pn = env.env_properties.physical_normalizations
    rand = lambda lo, hi: leaf((lo + (hi - lo) * torch.rand(batch, generator=gen, device=DEVICE,
                                                            dtype=torch.float64)).to(dtype))
    state0 = (rand(lim_i * pn.i_d.min, 0.0), rand(-lim_i * pn.i_q.max, lim_i * pn.i_q.max), rand(-3.0, 3.0),
              rand(-50.0, 50.0), rand(-50.0, 50.0))
    return state0, rand(0.0, 0.3 * pn.omega_el.max)


def grad_inputs_pmsm(ex, PK, dtype, gen, batch, n_steps, stride=None, solver="euler", deadtime=1, sim_ahead=False,
                     batch_major=False, per_batch=False, variant="BRUSA", saturated=True, holding=False, noise=()):
    static = {"deadtime": deadtime}
    if per_batch:
        static.update(r_s=0.015 + 0.006 * torch.rand(batch, generator=gen, device=DEVICE, dtype=torch.float64),
                      u_dc=300.0 + 150.0 * torch.rand(batch, generator=gen, device=DEVICE, dtype=torch.float64))
    env = pmsm_env(ex, batch, variant, saturated, dtype, static=static, solver=solver)
    props = env.env_properties
    pt = [leaf(t) for t in PK.ck.prop_tensors(props)]
    props = PK.ck.props_with(props, pt)
    if holding:
        state, acts_bm = holding_fleet(ex, env, gen, n_steps)
        state0 = tuple(leaf(t) for t in PK._start(state)[0])
        omega = leaf(state.physical_state.omega_el)
        slab = leaf(acts_bm if batch_major else acts_bm.transpose(0, 1).contiguous())
    else:
        state0, omega = pmsm_grad_state(env, gen, batch, dtype)
        # full-scale actions: the hexagon clips some, so the DC link gets a real cotangent
        u = torch.rand((n_steps, batch, 2), generator=gen, device=DEVICE, dtype=torch.float64)
        slab = (u * 2 - 1).to(dtype)
        slab = leaf(slab.transpose(0, 1).contiguous() if batch_major else slab)
    # a process-noise slab on the currents ``noise`` (indices into (i_d, i_q))
    noise_tm = leaf(0.05 * torch.randn((n_steps, batch, len(noise)), generator=gen, device=DEVICE,
                                       dtype=dtype)) if noise else None
    kw = dict(tau=env.tau, props=props, obs_stride=stride, sim_ahead=sim_ahead, batch_major=batch_major,
              noise_tm=noise_tm, noise_idx=tuple(noise))
    run_k = lambda: PK.pmsm_kernel_rollout(env, slab, state0, omega, **kw)
    run_p = lambda: PK.plain_pmsm_rollout(env, slab, state0, omega, **kw)
    inputs = [slab, *state0, omega, *pt] + ([noise_tm] if noise else [])
    return run_k, run_p, inputs, PK.KERNEL, "pmsm_sim_ahead" if sim_ahead else "pmsm_step"


def grad_inputs_pcl(ex, PCL, dtype, gen, batch, n_steps, stride=None, solver="euler", deadtime=1, pi=False,
                    noise=False, per_batch=False, variant="BRUSA", saturated=True):
    static = {"deadtime": deadtime}
    if per_batch:
        static.update(r_s=0.015 + 0.006 * torch.rand(batch, generator=gen, device=DEVICE, dtype=torch.float64),
                      u_dc=300.0 + 150.0 * torch.rand(batch, generator=gen, device=DEVICE, dtype=torch.float64))
    env = pmsm_env(ex, batch, variant, saturated, dtype, static=static, solver=solver, control_state=["i_d", "i_q"])
    props = env.env_properties
    pt = [leaf(t) for t in PCL.ck.prop_tensors(props)]
    props = PCL.ck.props_with(props, pt)
    state0, omega = pmsm_grad_state(env, gen, batch, dtype)
    refs = (leaf(-0.6 * torch.rand(batch, generator=gen, device=DEVICE).to(dtype)),
            leaf((torch.rand(batch, generator=gen, device=DEVICE) - 0.5).to(dtype)))
    policy = ex.AffinePolicy([[3 * k for k in row] for row in PCL_P], Ki=PCL_KI if pi else None)
    gains = leaf(policy.flat_params().to(device=DEVICE, dtype=dtype))
    carry = tuple(leaf(0.1 * (torch.rand(batch, generator=gen, device=DEVICE) - 0.5).to(dtype))
                  for _ in range(2)) if pi else None
    on = leaf(0.02 * torch.randn((n_steps, batch, 2), generator=gen, device=DEVICE, dtype=dtype)) if noise else None
    pn = leaf(0.5 * torch.randn((n_steps, batch, 1), generator=gen, device=DEVICE, dtype=dtype)) if noise else None
    kw = dict(tau=env.tau, solver=env._solver, props=props, ref_leaves=refs, traj_stride=stride,
              policy_params=gains, policy_carry=carry, obs_noise_tm=on, proc_noise_tm=pn,
              obs_noise_cols=(0, 1) if noise else (), proc_noise_idx=(1,) if noise else ())
    run_k = lambda: PCL.kernel_pmsm_closed_loop(env, state0, omega, policy, n_steps, **kw)
    run_p = lambda: PCL.plain_pmsm_closed_loop(env, state0, omega, policy, n_steps, **kw)
    inputs = [*state0, omega, *refs, gains, *(carry or ()), *pt] + ([on, pn] if noise else [])
    return run_k, run_p, inputs, PCL.PMSM_CL_KERNEL, "pmsm_closed_loop"


#: (entry point, label, keyword arguments of its inputs), the CPU tests' cases
GRAD_CASES = [
    ("kernel_rollout", "pendulum euler, final only", dict(name="Pendulum")),
    ("kernel_rollout", "pendulum rk4, saves every 8 (checkpoints every 4)", dict(name="Pendulum", solver="rk4", stride=8)),
    ("kernel_rollout", "pendulum rk4, prime T = 13", dict(name="Pendulum", solver="rk4", n_steps=13)),
    ("kernel_rollout", "cart_pole tsit5, saves every 4", dict(name="CartPole", solver="tsit5", stride=4)),
    ("kernel_rollout", "pendulum rk4 sim-ahead, hold 2", dict(name="Pendulum", solver="rk4", stride=4, sim_ahead=True,
                                                             hold=2)),
    ("kernel_rollout", "pendulum tsit5 sim-ahead", dict(name="Pendulum", solver="tsit5", stride=4, sim_ahead=True)),
    ("kernel_rollout", "pendulum euler, process-noise slab", dict(name="Pendulum", stride=4, noise=True)),
    ("kernel_rollout", "pendulum rk4, per-batch l and action band", dict(name="Pendulum", solver="rk4", stride=4,
                                                                        per_batch=True)),
    ("kernel_rollout", "pendulum rk4, batch-major slab", dict(name="Pendulum", solver="rk4", stride=4,
                                                             batch_major=True)),
    ("kernel_rollout", "acrobot tsit5, saves every 4", dict(name="Acrobot", solver="tsit5", stride=4)),
    ("kernel_closed_loop", "pendulum euler PD, final only", dict(name="Pendulum")),
    ("kernel_closed_loop", "pendulum rk4 PD, saves every 8", dict(name="Pendulum", solver="rk4", stride=8)),
    ("kernel_closed_loop", "pendulum rk4 PD, prime T = 13", dict(name="Pendulum", solver="rk4", n_steps=13)),
    ("kernel_closed_loop", "pendulum rk4 PI, both noise slabs", dict(name="Pendulum", solver="rk4", stride=4, pi=True,
                                                                     noise=True)),
    ("kernel_closed_loop", "pendulum euler PD, per-batch l", dict(name="Pendulum", stride=4, per_batch=True)),
    ("kernel_closed_loop", "cart_pole tsit5 affine", dict(name="CartPole", solver="tsit5", stride=4)),
    ("kernel_closed_loop", "pendulum rk4 actor (16, 16) deterministic", dict(name="Pendulum", solver="rk4", stride=4,
                                                                             actor=True)),
    # a bias of 0.8 on both axes: |u| up to 1.13 x 325 V against the circle's 231 V, so the constraint is
    # active on part of the fleet
    ("kernel_closed_loop", "induction machine rk4 PI, u_dc 400, beyond the circle on part of the fleet",
     dict(name="InductionMachine", solver="rk4", stride=4, pi=True, u_dc=U_DC, bias=0.8)),
    ("kernel_closed_loop", "induction machine euler FOC tile (utils/foc.py), saves every 4",
     dict(name="InductionMachine", stride=4, foc_tile=True)),
    ("pmsm_kernel_rollout", "BRUSA euler deadtime 1, final only", dict()),
    ("pmsm_kernel_rollout", "BRUSA euler deadtime 0, saves every 4", dict(deadtime=0, stride=4)),
    ("pmsm_kernel_rollout", "BRUSA euler, saves every 8", dict(stride=8)),
    ("pmsm_kernel_rollout", "BRUSA euler, prime T = 13", dict(n_steps=13)),
    ("pmsm_kernel_rollout", "BRUSA rk4, saves every 8", dict(solver="rk4", stride=8)),
    ("pmsm_kernel_rollout", "BRUSA tsit5 sim-ahead deadtime 1", dict(solver="tsit5", sim_ahead=True, stride=1)),
    ("pmsm_kernel_rollout", "BRUSA tsit5 sim-ahead deadtime 0", dict(solver="tsit5", sim_ahead=True, stride=1,
                                                                     deadtime=0)),
    ("pmsm_kernel_rollout", "BRUSA euler, batch-major slab", dict(stride=4, batch_major=True)),
    ("pmsm_kernel_rollout", "BRUSA euler, per-batch r_s and DC link", dict(stride=4, per_batch=True)),
    ("pmsm_kernel_rollout", "DEFAULT linear rk4", dict(solver="rk4", stride=4, variant="DEFAULT", saturated=False)),
    ("pmsm_kernel_rollout", "BRUSA euler, process-noise slab on both currents", dict(stride=4, noise=(0, 1))),
    ("pmsm_kernel_rollout", "DEFAULT linear rk4 deadtime 0, process-noise slab on i_q",
     dict(solver="rk4", stride=4, deadtime=0, variant="DEFAULT", saturated=False, noise=(1,))),
    ("kernel_pmsm_closed_loop", "BRUSA P deadtime 1, final only", dict()),
    ("kernel_pmsm_closed_loop", "BRUSA P deadtime 0, saves every 4", dict(deadtime=0, stride=4)),
    ("kernel_pmsm_closed_loop", "BRUSA PI, saves every 8", dict(pi=True, stride=8)),
    ("kernel_pmsm_closed_loop", "BRUSA PI, prime T = 13", dict(pi=True, n_steps=13)),
    ("kernel_pmsm_closed_loop", "BRUSA P rk4, both noise slabs", dict(solver="rk4", stride=4, noise=True)),
    ("kernel_pmsm_closed_loop", "BRUSA P tsit5 deadtime 0", dict(solver="tsit5", stride=1, deadtime=0)),
    ("kernel_pmsm_closed_loop", "BRUSA P, per-batch r_s and DC link", dict(stride=4, per_batch=True)),
    ("kernel_pmsm_closed_loop", "DEFAULT linear P rk4", dict(solver="rk4", stride=4, variant="DEFAULT",
                                                             saturated=False)),
]


#: the full-width gradient cases' horizons, cut from 1,024 and 256 to keep
#: the script's phases under ~700 s (the replay is eager, ~linear in T)
GRAD_FULL_T, GRAD_FULL_T_PMSM = 512, 128


def phase_grad(ex, K, CL, PK, PCL):
    """The four VJPs on the card, float32 and float64: each case of
    GRAD_CASES at B = 4,096 (T = 16 unless stated), then one full-width case
    per kernel in float32; every gradient within GRAD_LIMIT of autograd
    through the plain loop, the forward outputs 0.0 from the plain version,
    one launch per forward, and no checkpoint saves without grad.  Returns
    the entries of the ``grads`` line."""
    make_inputs = {"kernel_rollout": lambda dtype, gen, kw: grad_inputs_stepper(ex, K, dtype=dtype, gen=gen, **kw),
                "kernel_closed_loop": lambda dtype, gen, kw: grad_inputs_cl(ex, CL, dtype=dtype, gen=gen, **kw),
                "pmsm_kernel_rollout": lambda dtype, gen, kw: grad_inputs_pmsm(ex, PK, dtype, gen, **kw),
                "kernel_pmsm_closed_loop": lambda dtype, gen, kw: grad_inputs_pcl(ex, PCL, dtype, gen, **kw)}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    entries, failures = [], []

    def check(entry_point, label, dtype, kw, seed):
        kw = dict(kw)
        kw.setdefault("batch", B_GRAD)
        kw.setdefault("n_steps", T_GRAD)
        run_k, run_p, inputs, lib, mode = make_inputs[entry_point](dtype, gen, kw)
        dev, fwd_err, launches, fwd_ms, bwd_ms = grad_case(run_k, run_p, inputs, lib, mode, seed)
        limit = GRAD_LIMIT[dtype]
        ok = dev <= limit and fwd_err == 0.0 and launches == 1
        name = str(dtype).replace("torch.", "")
        log(f"[grad] {entry_point} {label}, {name}, B={kw['batch']} T={kw['n_steps']}: gradient deviation {dev!r} "
            f"(limit {limit}), forward vs plain {fwd_err!r}, {launches} launch, forward {fwd_ms:.2f} ms, "
            f"backward {bwd_ms:.2f} ms {'ok' if ok else 'FAIL'}")
        entries.append({"entry": entry_point, "case": label, "dtype": name, "batch": kw["batch"],
                        "n_steps": kw["n_steps"], "deviation": dev, "forward_deviation": fwd_err,
                        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms})
        if not ok:
            failures.append(f"{entry_point} {label} {name}")

    for dtype in (torch.float32, torch.float64):
        for i, (entry_point, label, kw) in enumerate(GRAD_CASES):
            check(entry_point, label, dtype, kw, SEED + i)
    full = [
        ("kernel_rollout", "Pendulum main case, obs_stride 64", dict(name="Pendulum", batch=B_MAIN,
                                                                     n_steps=GRAD_FULL_T, stride=64)),
        ("kernel_closed_loop", "Pendulum PD tracking, obs_stride 64", dict(name="Pendulum", batch=B_MAIN,
                                                                           n_steps=GRAD_FULL_T, stride=64)),
        ("pmsm_kernel_rollout", "BRUSA holding fleet, obs_stride 16", dict(batch=B_MAIN, n_steps=GRAD_FULL_T_PMSM,
                                                                          stride=16, holding=True,
                                                                          batch_major=True)),
        ("kernel_pmsm_closed_loop", "BRUSA P law, obs_stride 16", dict(batch=B_MAIN, n_steps=GRAD_FULL_T_PMSM,
                                                                       stride=16)),
    ]
    for entry_point, label, kw in full:
        check(entry_point, label, torch.float32, kw, SEED)
        torch.cuda.empty_cache()
    # without grad: one launch with the user's stride and no checkpoint saves,
    # so the call allocates its outputs and nothing else
    env = make_env(ex.Pendulum, B_MAIN, control_state=["theta"])
    y0, refs = random_state(env, gen), (random_state(env, gen)[0],)
    gains = ex.AffinePolicy(PD_GAINS).flat_params().to(device=DEVICE, dtype=torch.float32)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs)
    out_bytes = 2 * B_MAIN * 4
    plain_call = extra_memory(lambda: CL.kernel_closed_loop(env, y0, ex.AffinePolicy(PD_GAINS), 1024,
                                                            policy_params=gains, **kw))
    with torch.enable_grad():
        g = gains.clone().requires_grad_(True)
        grad_call = extra_memory(lambda: CL.kernel_closed_loop(env, y0, ex.AffinePolicy(PD_GAINS), 1024,
                                                               policy_params=g, **kw))
    ok = plain_call < out_bytes + (1 << 16) < grad_call
    log(f"[grad] no grad: the closed loop over T = 1,024 allocates {plain_call} B at its peak (outputs {out_bytes} "
        f"B); with grad {grad_call} B (the checkpoint saves) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("a call without grad allocated more than its outputs")
    if failures:
        raise AssertionError(f"gradient checks failed: {failures}")
    return entries


class TimedVJP:
    """Host-clock times (synchronized) of each forward and backward of the
    VJP Functions, by patching their ``forward``/``backward`` for the
    duration of a ``with`` block."""

    def __init__(self, *functions):
        self.functions = functions
        self.fwd_ms, self.bwd_ms = [], []

    def _wrap(self, fn, sink):
        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    def __enter__(self):
        self.saved = [(f, f.forward, f.backward) for f in self.functions]
        for f, fwd, bwd in self.saved:
            f.forward = staticmethod(self._wrap(fwd, self.fwd_ms))
            f.backward = staticmethod(self._wrap(bwd, self.bwd_ms))
        return self

    def __exit__(self, *exc):
        for f, fwd, bwd in self.saved:
            f.forward, f.backward = staticmethod(fwd), staticmethod(bwd)


#: iterations of phase_train's two longest runs, cut from 10 and 12 to keep
#: the script's phases under ~700 s (each iteration replays 1-2 s of VJP)
TRAIN_PD_ITERS, TRAIN_BRUSA_ITERS = 5, 6


def phase_train(ex, CL, PCL):
    """The README's training flow at full width: ``train_policy`` on the
    tracking pendulum (B = 65,536, references linspace(-1.5, 1.5)) with an
    ``AffinePolicy`` PD law over 1,024 steps and ``TRAIN_PD_ITERS``
    iterations, the PI law over 256 steps and 10 iterations, and on
    saturated BRUSA (B = 65,536) an ``AffinePolicy`` over the 10 columns
    from kd = kq = 0.3, 128 steps and ``TRAIN_BRUSA_ITERS`` iterations with
    benchmarks/r03/pmsm_policy_grad_device.py's clipped loss; each must end below its first loss with finite parameters.  Logs
    each iteration's forward, backward and optimizer ms.  Returns the
    entries of the ``grads`` line."""
    from exciting_environments_torch.utils.train import train_policy

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    pend = make_env(ex.Pendulum, B_MAIN, control_state=["theta"])
    _, pstate = pend.vmap_reset(rng=gen)
    pstate.reference.theta = torch.linspace(-1.5, 1.5, B_MAIN, device=DEVICE)
    drive = pmsm_env(ex, B_MAIN, control_state=["i_d", "i_q"])
    _, dstate = drive.vmap_reset(rng=gen)
    dstate.reference.i_d = torch.linspace(-200.0, -10.0, B_MAIN, device=DEVICE)
    dstate.reference.i_q = torch.linspace(-150.0, 150.0, B_MAIN, device=DEVICE)

    def clipped(obs, acts):
        e_d = torch.clamp(obs[:, :, 0] - obs[:, :, 8], -3.0, 3.0)
        e_q = torch.clamp(obs[:, :, 1] - obs[:, :, 9], -3.0, 3.0)
        return torch.mean(e_d ** 2 + e_q ** 2)

    # tests/test_train.py's stochastic pendulum: the draws follow the state's
    # keys, the same every iteration (common random numbers)
    noisy = make_env(ex.Pendulum, B_MAIN, tau=1e-2, control_state=["theta"], process_noise={"omega": 0.2},
                     observation_noise={"theta": 0.03})
    _, nstate = noisy.vmap_reset(noise_keys(B_MAIN, SEED + 22))
    nstate.reference.theta = torch.linspace(-1.2, 1.2, B_MAIN, device=DEVICE)
    k_drive = [[-0.3, 0, 0, 0, 0, 0, 0, 0, 0.3, 0], [0, -0.3, 0, 0, 0, 0, 0, 0, 0, 0.3]]
    runs = [
        ("noisy pendulum PD", noisy, nstate, ex.AffinePolicy([[-0.1, 0.0, 0.1]]), 24, 10, None, None),
        ("pendulum PD", pend, pstate, ex.AffinePolicy(PD_GAINS), 1024, TRAIN_PD_ITERS, None, None),
        ("pendulum PI", pend, pstate, ex.AffinePolicy(**PI_LAW), 256, 10,
         (torch.zeros(B_MAIN, device=DEVICE),), None),
        ("BRUSA P", drive, dstate, ex.AffinePolicy(k_drive), 128, TRAIN_BRUSA_ITERS, None, clipped),
    ]
    entries, failures = [], []
    for label, env, state, policy, n_steps, iterations, carry, loss_fn in runs:
        opt_ms = []

        def adam(params, opt_ms=opt_ms):
            opt = torch.optim.Adam(params, lr=0.1)
            step = opt.step

            def timed_step(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*a, **k)
                torch.cuda.synchronize()
                opt_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            opt.step = timed_step
            return opt

        params = policy.flat_params().to(device=DEVICE, dtype=torch.float32)
        CL.CL_KERNEL.reset_counts()
        PCL.PMSM_CL_KERNEL.reset_counts()
        t0 = time.perf_counter()
        with TimedVJP(CL.ClosedLoopVJP, PCL.PmsmClosedLoopVJP) as timer:
            res = train_policy(env, policy, params, state, n_steps=n_steps, iterations=iterations,
                               optimizer=adam, loss_fn=loss_fn, policy_carry=carry)
        wall = time.perf_counter() - t0
        launches = CL.CL_KERNEL.launches["closed_loop"] + PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"]
        for i in range(iterations):
            log(f"[train] {label} iteration {i}: loss {float(res.losses[i])!r}, kernel forward "
                f"{timer.fwd_ms[i]:.2f} ms, backward {timer.bwd_ms[i]:.1f} ms, optimizer {opt_ms[i]:.3f} ms")
        if env is drive:
            # its backwards take the adjoint kernel (a save every step, the affine law, Euler)
            log(f"[train] {label}: backward paths so far {PCL.BACKWARD_PATHS}")
        finite = bool(torch.isfinite(res.params).all()) and bool(torch.isfinite(res.losses).all())
        ok = res.final_loss < float(res.losses[0]) and finite and launches == iterations + 1
        log(f"[train] {label}, B={env.batch_size} T={n_steps}: loss {float(res.losses[0])!r} -> {res.final_loss!r}, "
            f"{launches} launches (one per iteration and the final loss), {wall:.1f} s {'ok' if ok else 'FAIL'}")
        entries.append({"entry": "train_policy", "case": label, "dtype": "float32", "batch": env.batch_size,
                        "n_steps": n_steps, "first_loss": float(res.losses[0]), "final_loss": res.final_loss,
                        "fwd_ms": statistics.median(timer.fwd_ms), "bwd_ms": statistics.median(timer.bwd_ms),
                        "opt_ms": statistics.median(opt_ms)})
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"training did not lower the loss: {failures}")
    return entries


ADJ_SOURCE = "exciting_environments_torch/csrc/pmsm_closed_loop_adjoint.cu"
ADJ_REPLACES = "exciting_environments_tpu/ops/pallas/pmsm_stepper.py:2394 (_pmsm_cl_core_bwd, a jax.vjp replay)"
#: per drive-step of csrc/pmsm_closed_loop_adjoint.cu without the law, the law's at 10 columns with its
#: integrator, and once a drive at the end (portbench/configs/pmsm_brusa_tune.json's count)
ADJ_OPS, ADJ_LAW_OPS, ADJ_OPS_FINAL = 408, 156, 160


def phase_adjoint(ex, PCL):
    """Row 4i: the PMSM closed loop's adjoint kernel at the tuning cell's size
    (B = 65,536 saturated BRUSA drives, T = 256, float32, the dense PI law a
    few steps off the PI cell's gains), on the forward kernel's saves and
    the five cotangent planes a tracking loss hands it: its time (CUDA
    events), its bound, its deviation from ``plain_pmsm_cl_adjoint`` on the
    card, two launches bit for bit, the launches of one call (counted after
    a reset); then one whole backward through the adjoint and one through
    the eager replay (a reference requiring grad takes it), each on the host
    clock, and ``BACKWARD_PATHS``; then row 4j (:func:`phase_angles_row`)."""
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop_adjoint as PCA

    B, T = B_MAIN, 256
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 29)
    env = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4,
                  control_state=["i_d", "i_q"], device=DEVICE)
    draw = lambda lo, hi, shape=(B,): lo + (hi - lo) * torch.rand(shape, generator=gen, device=DEVICE)
    state0 = (draw(-200.0, -10.0), draw(-150.0, 150.0), draw(-3.14, 3.14), torch.zeros(B, device=DEVICE),
              torch.zeros(B, device=DEVICE))
    omega = draw(0.0, 1000.0)
    pn = env.env_properties.physical_normalizations
    refs = (pn.i_d.normalize(draw(-200.0, -10.0)), pn.i_q.normalize(draw(-150.0, 150.0)))
    law = ex.AffinePolicy(PCL_P, Ki=PCL_KI)
    flat = (law.flat_params().to(DEVICE) + 0.01 * torch.randn(42, generator=gen, device=DEVICE, dtype=torch.float64)
            ).float()
    carry0 = (torch.zeros(B, device=DEVICE), torch.zeros(B, device=DEVICE))
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs)
    _, _, _, traj, _ = PCL.kernel_pmsm_closed_loop(env, state0, omega, law, T, traj_stride=1, policy_params=flat,
                                                   policy_carry=carry0, **kw)
    planes = tuple(draw(-1e-7, 1e-7, (T, B)) if i < 5 else None for i in range(7))
    cot = PCL.AdjointCotangents(planes, (None, None), (None,) * 6, (None, None), (None, None))
    adjoint = lambda: PCA.kernel_pmsm_cl_adjoint(env, law, flat, state0, omega, refs, carry0, traj, cot,
                                                 tau=env.tau, props=env.env_properties)
    got = adjoint()
    PCA.PMSM_CL_ADJOINT_KERNEL.reset_counts()
    again = adjoint()
    launches = PCA.PMSM_CL_ADJOINT_KERNEL.launches["adjoint"]
    flat_out = lambda out: [*out[0], *out[1], out[2]]
    same = all(torch.equal(a, b) for a, b in zip(flat_out(got), flat_out(again)))
    ms = time_ms(adjoint)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eps_starts = PCL._eps_starts(state0[2], omega, env.tau, env._solver, T, 1)
    want = PCL.plain_pmsm_cl_adjoint(env, law, flat, state0, omega, refs, carry0, traj, eps_starts, cot,
                                     tau=env.tau, props=env.env_properties)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(float((a.double() - b.double()).abs().max()) / float(b.double().abs().max())
              for a, b in zip(flat_out(got), flat_out(want)))
    ops = ((ADJ_OPS + ADJ_LAW_OPS) * T + ADJ_OPS_FINAL) * B
    nbytes = 4 * (B * T * (6 + 5) + B * (8 + 7) + 2 * 42 + 8904)
    bound_ms, bound_by = roofline(nbytes, ops)
    log(f"[adjoint] B={B} T={T}: kernel {ms!r} ms (bound {bound_ms!r} ms by {bound_by}, {ops} operations, {nbytes} "
        f"bytes), {launches} launch(es) a call, relative deviation from the plain version {err!r}, two launches bit "
        f"for bit: {same}; the plain version {plain_ms:.1f} ms")

    def backward(replay):
        st = tuple(x.clone().requires_grad_(i == 0) for i, x in enumerate(state0))
        gains = flat.clone().requires_grad_(True)
        rf = tuple(r.clone().requires_grad_(replay) for r in refs)
        out = PCL.pmsm_closed_loop_vjp(env, st, omega, law, T, tau=env.tau, solver=env._solver,
                                       props=env.env_properties, ref_leaves=rf, traj_stride=1, policy_params=gains,
                                       policy_carry=carry0)
        loss = sum((o * p).sum() for o, p in zip(out[3][:5], planes))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, gains.grad

    backward(False)
    adj_ms, g_adj = backward(False)
    replay_ms, g_rep = backward(True)
    gap = float((g_adj.double() - g_rep.double()).abs().max()) / float(g_rep.double().abs().max())
    log(f"[adjoint] a whole backward through the adjoint {adj_ms:.2f} ms, through the eager replay {replay_ms:.1f} "
        f"ms ({replay_ms / adj_ms:.0f}x); gains' gradient gap {gap!r}; backward paths {PCL.BACKWARD_PATHS}")
    if not (same and launches == 1 and err < 1e-3 and gap < 1e-3):
        raise AssertionError("the adjoint kernel disagrees with its plain version or the replay, is not "
                             "reproducible, or takes other than one launch")
    return [entry("pmsm_closed_loop_adjoint", launches, err, ms, replay_ms, bound_ms, bound_by, ADJ_SOURCE,
                  ADJ_REPLACES), phase_angles_row(env, state0[2], omega, T)]


ANGLES_SOURCE = "exciting_environments_torch/csrc/pmsm_angles.cu"
ANGLES_REPLACES = "exciting_environments_torch/ops/kernels/pmsm_stepper.py::_eps_trajectory (an eager loop)"
#: per drive-step of csrc/pmsm_angles.cu: the increment's add, wrap_angle's add, sign and range compares, subtract
ANGLES_OPS = 6


def phase_angles_row(env, eps0, omega, T):
    """Row 4j: ``csrc/pmsm_angles.cu`` at the tuning cell's size (its
    rebuild of the observation's angles each call), against the eager
    ``_eps_trajectory`` it replaces, which it must match bit for bit: its
    launches in one call (counted after a reset), its time (CUDA events),
    its bound, and the eager loop's time as the plain ms."""
    from exciting_environments_torch.ops.kernels import pmsm_angles as PA
    from exciting_environments_torch.ops.kernels.pmsm_stepper import _eps_trajectory

    B = eps0.shape[0]
    run = lambda: PA.angle_trajectory(eps0, omega, env.tau, T, env._solver)
    run()
    PA.PMSM_ANGLES_KERNEL.reset_counts()
    seq, final = run()
    launches = PA.PMSM_ANGLES_KERNEL.launches["angles"]
    want_seq, want_final = _eps_trajectory(eps0, omega, env.tau, T, env._solver)
    err = max(float((seq.double() - want_seq.double()).abs().max()),
              float((final.double() - want_final.double()).abs().max()))
    ms = time_ms(run)
    plain_ms = time_ms(lambda: _eps_trajectory(eps0, omega, env.tau, T, env._solver))
    ops, nbytes = (ANGLES_OPS * T + 1) * B, 4 * B * (T + 3)
    bound_ms, bound_by = roofline(nbytes, ops)
    log(f"[angles] B={B} T={T} float32: kernel {ms!r} ms (bound {bound_ms!r} ms by {bound_by}, {ops} operations, "
        f"{nbytes} bytes), {launches} launch(es) a call, largest deviation from the eager loop {err!r}; the eager "
        f"loop {plain_ms!r} ms")
    if not (err == 0.0 and launches == 1):
        raise AssertionError("the angle kernel differs from the eager recurrence, or takes other than one launch")
    return entry("pmsm_angles", launches, err, ms, plain_ms, bound_ms, bound_by, ANGLES_SOURCE, ANGLES_REPLACES)


# ---------------------------------------------------------------------------
# the learning stack: PPO with kernel collection, eager PPO and SAC
# ---------------------------------------------------------------------------

RL_B, RL_T, RL_ITERATIONS = 65536, 64, 3  # benchmarks/r05/rl_profile_device.py:34-35
#: benchmarks/r03/ppo_device.py:23-24 and benchmarks/r03/sac_device.py:20-22
PPO_B, PPO_CONFIG = 4096, dict(n_steps=128, n_epochs=4, n_minibatches=4, max_episode_steps=256)
SAC_B, SAC_CONFIG = 4096, dict(n_steps=8, updates_per_iteration=8, update_batch_size=4096, buffer_capacity=2**19,
                               learning_starts=2**15, max_episode_steps=256)


class TimedCalls:
    """Wraps functions of a module with host-clock timers (the card
    synchronized before and after each call); ``ms[name]`` lists each
    call's time.  Restores them on exit."""

    def __init__(self, module, names):
        self.module, self.names, self.ms, self.saved = module, names, {n: [] for n in names}, {}

    def __enter__(self):
        for name in self.names:
            fn = self.saved[name] = getattr(self.module, name)

            def timed(*a, _fn=fn, _name=name, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                self.ms[_name].append((time.perf_counter() - t0) * 1e3)
                return out
            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def phase_rl(ex, CL, PCL):
    """The model-free RL entry points at the JAX package's device-script
    widths.  Kernel collection (``train_ppo_fused(collector="kernel")``, B =
    65,536, ``chunk_steps`` 64, 3 iterations) on the tracking Pendulum and on
    saturated BRUSA: one launch per chunk, the first chunk's slabs equal to
    the scan collector's at 0.0, finite metrics and each iteration's
    collection, transition and update ms; the PMSM actor kernel at that
    width against its plain version, timed, with its bound (row 4e).  Then
    the eager trainers at B = 4,096: ``train_ppo`` for 2 iterations and
    ``train_sac`` for 5, finite metrics, env-steps/s.  Returns the kernel
    table's entries."""
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.utils import episodes, rl, rl_fused as RF, sac

    entries, failures = [], []
    cfg = RF.FusedPPOConfig(chunk_steps=RL_T)
    envs = [
        ("Pendulum", ex.Pendulum(batch_size=RL_B, tau=2e-2, control_state=["theta"], device=DEVICE)),
        ("BRUSA", ex.PMSM(batch_size=RL_B, saturated=True, motor_variant=ex.MotorVariant.BRUSA,
                          control_state=["i_d", "i_q"], device=DEVICE)),
    ]
    for label, env in envs:
        key = R.PRNGKey(SEED, DEVICE)
        # the first chunk as train_ppo_fused draws it: both collectors, the same actor and state
        k_init, k_run = R.split(key)
        params = RF.init_fused_agent(env, k_init, cfg)
        _, k_it = R.split(k_run)
        _, k_chunk = R.split(k_it)
        _, state0 = episodes.reset_with_references(env, k_chunk)
        tile, ids = RF.make_actor_tile(env)
        actor = {"actor": params["actor"], "log_std": params["log_std"],
                 "seed": torch.tensor(0.0, device=DEVICE)}
        kernel_slabs = RF._collect_chunk(env, actor, state0, tile, ids, RL_T, "kernel")
        scan_slabs = RF._collect_chunk(env, actor, state0, tile, ids, RL_T, "scan")
        torch.cuda.synchronize()
        chunk_err = max_abs(kernel_slabs[:2], scan_slabs[:2])
        del kernel_slabs, scan_slabs

        CL.CL_KERNEL.reset_counts()
        PCL.PMSM_CL_KERNEL.reset_counts()
        t0 = time.perf_counter()
        with TimedCalls(RF, ("_collect_chunk", "_chunk_transitions", "_minibatch_updates")) as timer:
            res = RF.train_ppo_fused(env, RL_ITERATIONS, key=key, config=cfg, collector="kernel")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = CL.CL_KERNEL.launches["closed_loop"] + PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"]
        for i in range(RL_ITERATIONS):
            log(f"[rl] train_ppo_fused {label} iteration {i}: collection {timer.ms['_collect_chunk'][i]:.2f} ms, "
                f"transitions {timer.ms['_chunk_transitions'][i]:.2f} ms, update "
                f"{timer.ms['_minibatch_updates'][i]:.1f} ms; mean reward {float(res.metrics['mean_reward'][i])!r}")
        finite = all(bool(torch.isfinite(v).all()) for v in res.metrics.values())
        finite = finite and all(bool(torch.isfinite(t).all()) for t in rl.tree_leaves(res.params))
        ok = finite and launches == RL_ITERATIONS * cfg.n_chunks and chunk_err == 0.0
        steps = RL_ITERATIONS * RL_B * RL_T
        log(f"[rl] train_ppo_fused {label} B={RL_B} chunk_steps={RL_T}, {RL_ITERATIONS} iterations: {launches} "
            f"launches (one per chunk), first chunk kernel vs scan max abs {chunk_err!r} (tolerance 0.0), "
            f"{wall:.2f} s = {steps / wall:.4e} env-steps/s, approx_kl {res.metrics['approx_kl'].tolist()} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"train_ppo_fused {label}")
        if label != "BRUSA":
            continue
        # row 4e: the actor's PMSM kernel at the collection's width
        pn = env.env_properties.physical_normalizations
        phys = state0.physical_state
        drive0 = (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
        refs = tuple(getattr(pn, n).normalize(getattr(state0.reference, n)) for n in env.control_state)
        kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs, traj_stride=1,
                  policy_params=actor, policy_carry=ids)
        kernel_fn = lambda: PCL.kernel_pmsm_closed_loop(env, drive0, phys.omega_el, tile, RL_T, **kw)
        outk = cl_flat(kernel_fn())
        t0 = time.perf_counter()
        outp = cl_flat(PCL.plain_pmsm_closed_loop(env, drive0, phys.omega_el, tile, RL_T, **kw))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs(outk, outp)
        del outk, outp
        ms = time_ms(kernel_fn)
        spec = tile.kernel_spec(torch.float32, DEVICE, actor)
        (bound_ms, bound_by), per_step = pmsm_cl_bound(env, spec, RL_B, RL_T, RL_T, 1, 2)
        log(f"[rl] pmsm_closed_loop_actor (row 4e), BRUSA B={RL_B} T={RL_T} float32, a save every step: kernel "
            f"{ms!r} ms = {RL_B * RL_T / ms * 1e3:.4e} env-steps/s; bound {bound_ms!r} ms ({bound_by}, {per_step} "
            f"operations per step and drive), {bound_ms / ms:.1%} of the bound; plain {plain_ms!r} ms (one run); "
            f"max abs {err!r} (tolerance 0.0)")
        if err != 0.0:
            failures.append("pmsm_closed_loop_actor kernel vs plain")
        entries.append(entry("pmsm_closed_loop_actor", launches, err, ms, plain_ms, bound_ms, bound_by, PCL_SOURCE,
                             PCL_REPLACES))

    # the eager trainers, Pendulum tracking at B = 4,096
    for label, iterations, run in (
        ("train_ppo", 2, lambda env, it: rl.train_ppo(env, it, key=R.PRNGKey(SEED, DEVICE),
                                                      config=rl.PPOConfig(**PPO_CONFIG))),
        ("train_sac", 5, lambda env, it: sac.train_sac(env, it, key=R.PRNGKey(SEED, DEVICE),
                                                       config=sac.SACConfig(**SAC_CONFIG))),
    ):
        batch = PPO_B if label == "train_ppo" else SAC_B
        n_steps = (PPO_CONFIG if label == "train_ppo" else SAC_CONFIG)["n_steps"]
        env = ex.Pendulum(batch_size=batch, tau=2e-2, control_state=["theta"], device=DEVICE)
        t0 = time.perf_counter()
        res = run(env, iterations)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        finite = all(bool(torch.isfinite(v).all()) for v in res.metrics.values())
        # SAC updates from the end of the first iteration that has stored
        # learning_starts transitions (its policy acts from the next one)
        expect = [(i + 1) * batch * n_steps >= SAC_CONFIG["learning_starts"] for i in range(iterations)]
        updated = label == "train_ppo" or [bool(q != 0) for q in res.metrics["q_loss"]] == expect
        steps = iterations * batch * n_steps
        log(f"[rl] {label} Pendulum B={batch}, {iterations} iterations: {wall:.2f} s = {steps / wall:.4e} "
            f"env-steps/s (host clock, setup included); metrics "
            f"{ {k: [round(float(x), 6) for x in v] for k, v in res.metrics.items()} } "
            f"{'ok' if finite and updated else 'FAIL'}")
        if not (finite and updated):
            failures.append(label)
    if failures:
        raise AssertionError(f"the learning stack failed: {failures}")
    return entries


# ---------------------------------------------------------------------------
# data generation: the collectors over kernels 1 and 3, adaptive integration
# ---------------------------------------------------------------------------

COLLECT_B = 65536
COLLECT_T = 2048  # benchmarks/r03/collector_device.py:30
BRUSA_COLLECT_T = 512  # benchmarks/r04/pmsm_pb_noise_device.py:50
NOISE_COLLECT_T = POLICY_COLLECT_T = 256
ADAPTIVE_B, ADAPTIVE_INTERVALS, ADAPTIVE_FINE = 8192, 8, 64  # benchmarks/r04/adaptive_device.py:93-101
ADAPTIVE_PMSM_B = 1024
BATCH_LEAVES = ("observations", "actions", "rewards", "terminated", "truncated")
#: the stage evaluations of one Tsit5 attempt: seven stages, the first reused (FSAL)
TSIT5_NEW_STAGES = 6


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def leaf_deviation(a, b):
    """The largest |a - b| over two leaves of one shape, a NaN on one side
    only counting as infinite; booleans compare as 0/1."""
    if a.shape != b.shape:
        return math.inf
    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=math.inf).max()) if d.numel() else 0.0


def collect_deviations(batch_f, final_f, batch_s, final_s, fields):
    """Per leaf of the TrajectoryBatch and of the final state (``fields`` and
    the keys), the deviation of the fused collector from the eager one."""
    devs = {name: leaf_deviation(getattr(batch_f, name), getattr(batch_s, name)) for name in BATCH_LEAVES}
    devs.update({f"final.{n}": leaf_deviation(getattr(final_f.physical_state, n), getattr(final_s.physical_state, n))
                 for n in fields})
    if isinstance(final_f.PRNGKey, torch.Tensor) and final_f.PRNGKey.dtype == torch.int64:
        devs["final.PRNGKey"] = leaf_deviation(final_f.PRNGKey, final_s.PRNGKey)
    return devs


def scaled_failures(devs, batch_s, final_s, limit=1e-6):
    """The leaves whose deviation is above ``limit`` times the leaf's largest
    magnitude (a leaf that cannot reach 0.0 is held there)."""
    bad = []
    for name, dev in devs.items():
        if dev == 0.0:
            continue
        ref = getattr(final_s.physical_state, name[6:]) if name.startswith("final.") and name != "final.PRNGKey" \
            else (final_s.PRNGKey if name == "final.PRNGKey" else getattr(batch_s, name))
        scale = float(torch.nan_to_num(ref.double().abs(), nan=0.0).max()) if ref.numel() else 0.0
        if not dev <= limit * max(scale, 1e-30):
            bad.append(name)
    return bad


def collect_bytes(env, batch, n_saved, table=0, n_params=0):
    """What a collection must move once: the action slab and the initial
    leaves read (per-batch parameters and a table too), then the saved
    per-step states (``n_saved`` leaves of the action slab's type) and the
    batch's observations, rewards and flags written, each leaf at the size
    the run gave it."""
    leaf_bytes = lambda t: t.numel() * t.element_size()
    B, T = batch.actions.shape[:2]
    itemsize = batch.actions.element_size()
    n_state = len(env._ode_state_fields) if hasattr(env, "_ode_state_fields") else 6
    read = leaf_bytes(batch.actions) + itemsize * ((n_state + n_params) * B + table)
    written = itemsize * B * T * n_saved + sum(leaf_bytes(getattr(batch, n))
                                               for n in ("observations", "rewards", "terminated", "truncated"))
    return read + written


def phase_collect(ex, K, PK):
    """Data generation on the card at the JAX package's device-script
    widths, float32, B = 65,536: ``RolloutCollector.collect_fused`` over an
    ``aprbs`` slab on the tracking Pendulum (T = 2,048, one launch of
    ``csrc/stepper.cu``, row 1k) and on a saturated BRUSA fleet with
    ``r_s`` drawn by ``randomize_env`` (T = 512, one launch of
    ``csrc/pmsm_stepper.cu``, row 3e), each equal to the eager ``collect``
    in every leaf (0.0); the noisy Pendulum in fast noise mode (T = 256,
    ``collect`` through ``_collect_fast_noise``); ``collect_policy`` with a
    Gaussian-exploration PD law (T = 256); then ``adaptive_rollout`` of a
    Van der Pol fleet with ``mu`` log-spaced over 1..300 (B = 8,192, tau
    5e-2, 8 intervals, rtol 1e-6, atol 1e-8) against a 64-times-finer
    fixed-step Tsit5 rollout through ``fused_rollout`` (one launch), the
    mass-spring-damper fleet with ``k`` over 1..1e6, and the PMSM's own
    interval loop on a per-batch ``r_s`` fleet (B = 1,024).  Returns the
    kernel table's entries."""
    from exciting_environments_torch.ops import adaptive as A
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.ops.kernels import rollout_path
    from exciting_environments_torch.ops.signals import aprbs
    from exciting_environments_torch.utils import randomize
    from exciting_environments_torch.utils.collect import RolloutCollector

    card = card_line()
    entries, failures = [], []
    B = COLLECT_B

    def log_c(msg):
        log(f"[collect] {msg} ({card})")

    def held(label, devs, batch_s, final_s):
        worst = max(devs.values())
        bad = scaled_failures(devs, batch_s, final_s)
        nonzero = {k: v for k, v in devs.items() if v != 0.0}
        log_c(f"{label}: collect_fused vs collect, largest deviation {worst!r}"
              + (f", nonzero leaves {nonzero}" if nonzero else " (0.0 in every leaf)")
              + (f", above 1e-6 of their scale: {bad}" if bad else ""))
        if bad:
            failures.append(f"{label} collect_fused vs collect")
        return worst

    # -- classic collection: the tracking Pendulum over an aprbs slab, row 1k
    T = COLLECT_T
    env = ex.Pendulum(batch_size=B, tau=1e-4, control_state=["theta"], device=DEVICE)
    if rollout_path(env) != "fused":
        raise AssertionError(f"the Pendulum left the stepper kernel's scope: {rollout_path(env)}")
    _, s0 = env.vmap_reset(R.split(R.PRNGKey(SEED, DEVICE), B))
    # benchmarks/r03/collector_device.py:40-47's references
    s0.reference.theta = R.uniform(R.PRNGKey(SEED + 2, DEVICE), B, torch.float32, -math.pi, math.pi)
    acts = aprbs(R.PRNGKey(SEED + 1, DEVICE), B, T, 1)
    col = RolloutCollector(env)
    K.KERNEL.reset_counts()
    batch_f, final_f = col.collect_fused(s0, acts)
    torch.cuda.synchronize()
    launches = K.KERNEL.launches["step"]
    if launches != 1 or sum(K.KERNEL.launches.values()) != 1:
        raise AssertionError(f"collect_fused on the Pendulum made {K.KERNEL.launches} launches, not one")
    t0 = time.perf_counter()
    batch_s, final_s = col.collect(s0, acts)
    torch.cuda.synchronize()
    collect_ms = (time.perf_counter() - t0) * 1e3
    err = held(f"Pendulum B={B} T={T}", collect_deviations(batch_f, final_f, batch_s, final_s, ("theta", "omega")),
               batch_s, final_s)
    del batch_s, final_s
    y0 = tuple(getattr(s0.physical_state, n) for n in env._ode_state_fields)
    kernel_fn = lambda: K.kernel_rollout(env, y0, acts, tau=env.tau, obs_stride=1, batch_major=True)
    yk, tk = kernel_fn()
    yp, tp = K.plain_rollout(env, y0, acts.transpose(0, 1), tau=env.tau, obs_stride=1)
    torch.cuda.synchronize()
    kernel_err = max(max_abs(yk, yp), max_abs(tk, tp))
    del yk, tk, yp, tp
    if kernel_err != 0.0:
        failures.append("stepper kernel vs plain with a save every step")
    obs_k, traj_k, fin_k = K.env_fused_rollout(env, s0, acts, obs_stride=1, return_traj_states=True)
    kernel_ms = time_ms(kernel_fn)
    entry_ms = time_ms(lambda: K.env_fused_rollout(env, s0, acts, obs_stride=1, return_traj_states=True))
    assemble_ms = time_ms(lambda: col._assemble_batch(obs_k, acts, traj_k, fin_k))
    del obs_k, traj_k, fin_k
    ms = time_ms(lambda: col.collect_fused(s0, acts))
    nbytes = collect_bytes(env, batch_f, 2)
    bound_ms, bound_by = roofline(nbytes, ops_per_step(env, env._solver, False) * B * T)
    log_c(f"row 1k Pendulum B={B} T={T} float32, aprbs slab: collect_fused {ms!r} ms = {B * T / ms * 1e3:.4e} "
          f"env-steps/s (one launch); the kernel with a save every step {kernel_ms!r} ms (vs plain max abs "
          f"{kernel_err!r}), env_fused_rollout with the trajectory {entry_ms!r} ms, _assemble_batch {assemble_ms!r} "
          f"ms ({assemble_ms / ms:.1%} of the call); bound {bound_ms!r} ms ({bound_by}: {nbytes / 1e9:.3f} GB of "
          f"slab, saved states, observations, rewards and flags), {bound_ms / ms:.1%} of it; eager collect "
          f"{collect_ms!r} ms (one run) = {B * T / collect_ms * 1e3:.4e} env-steps/s")
    entries.append(entry("stepper_collect", launches, err, ms, collect_ms, bound_ms, bound_by, SOURCE, REPLACES))
    del batch_f, final_f, acts, s0

    # -- a randomized saturated BRUSA fleet, row 3e
    T = BRUSA_COLLECT_T
    defaults = dict(ex.MotorVariant.BRUSA.get_params().static_params.__dict__)
    fleet = randomize.randomize_env(ex.PMSM, R.PRNGKey(3, DEVICE), {"r_s": randomize.Uniform(15e-3, 21e-3)},
                                    batch_size=B, defaults=defaults, saturated=True,
                                    motor_variant=ex.MotorVariant.BRUSA, control_state=["i_d", "i_q"],
                                    device=DEVICE)
    if rollout_path(fleet) != "pmsm_fused":
        raise AssertionError(f"the randomized BRUSA fleet left the PMSM kernel's scope: {rollout_path(fleet)}")
    _, s0 = fleet.vmap_reset(R.split(R.PRNGKey(SEED, DEVICE), B))
    s0.reference.i_d = torch.linspace(-200.0, -10.0, B, device=DEVICE)
    s0.reference.i_q = torch.linspace(-150.0, 150.0, B, device=DEVICE)
    acts = aprbs(R.PRNGKey(SEED + 4, DEVICE), B, T, 2, minval=-0.4, maxval=0.4)
    col = RolloutCollector(fleet)
    PK.KERNEL.reset_counts()
    batch_f, final_f = col.collect_fused(s0, acts)
    torch.cuda.synchronize()
    launches = PK.KERNEL.launches["pmsm_step"]
    if launches != 1 or sum(PK.KERNEL.launches.values()) != 1:
        raise AssertionError(f"collect_fused on the BRUSA fleet made {PK.KERNEL.launches} launches, not one")
    t0 = time.perf_counter()
    batch_s, final_s = col.collect(s0, acts)
    torch.cuda.synchronize()
    collect_ms = (time.perf_counter() - t0) * 1e3
    fields = ("i_d", "i_q", "epsilon", "torque", "u_d_buffer", "u_q_buffer")
    err = held(f"randomized BRUSA B={B} T={T}", collect_deviations(batch_f, final_f, batch_s, final_s, fields),
               batch_s, final_s)
    del batch_s, final_s
    state0, omega = PK._start(s0)
    kernel_fn = lambda: PK.pmsm_kernel_rollout(fleet, acts, state0, omega, tau=fleet.tau, obs_stride=1,
                                               batch_major=True)
    outk = [t for part in kernel_fn() for t in (part or ()) if t is not None]
    outp = [t for part in PK.plain_pmsm_rollout(fleet, acts, state0, omega, tau=fleet.tau, obs_stride=1,
                                                batch_major=True) for t in (part or ()) if t is not None]
    torch.cuda.synchronize()
    kernel_err = max_abs(outk, outp)
    del outk, outp
    if kernel_err != 0.0:
        failures.append("PMSM kernel vs plain with a save every step")
    obs_k, traj_k, fin_k = PK.pmsm_fused_rollout(fleet, s0, acts, obs_stride=1, return_traj_states=True)
    kernel_ms = time_ms(kernel_fn)
    entry_ms = time_ms(lambda: PK.pmsm_fused_rollout(fleet, s0, acts, obs_stride=1, return_traj_states=True))
    assemble_ms = time_ms(lambda: col._assemble_batch(obs_k, acts, traj_k, fin_k))
    del obs_k, traj_k, fin_k
    ms = time_ms(lambda: col.collect_fused(s0, acts))
    table = fleet._lut.interleaved().numel()
    nbytes = collect_bytes(fleet, batch_f, 6, table=table, n_params=1)
    bound_ms, bound_by = roofline(nbytes, pmsm_ops(fleet, fleet._solver, T, T) * B)
    log_c(f"row 3e randomized BRUSA (r_s per drive) B={B} T={T} float32, aprbs +-0.4: collect_fused {ms!r} ms = "
          f"{B * T / ms * 1e3:.4e} env-steps/s (one launch); the kernel with a save every step {kernel_ms!r} ms "
          f"(vs plain max abs {kernel_err!r}), pmsm_fused_rollout with the trajectory {entry_ms!r} ms, "
          f"_assemble_batch {assemble_ms!r} ms ({assemble_ms / ms:.1%} of the call); bound {bound_ms!r} ms "
          f"({bound_by}: {nbytes / 1e9:.3f} GB), {bound_ms / ms:.1%} of it; eager collect {collect_ms!r} ms "
          f"(one run) = {B * T / collect_ms * 1e3:.4e} env-steps/s")
    entries.append(entry("pmsm_stepper_collect", launches, err, ms, collect_ms, bound_ms, bound_by, PMSM_SOURCE,
                         PMSM_REPLACES))
    del batch_f, final_f, acts, s0

    # -- fast-mode noise: collect consumes the rollout's slab, as the kernel
    T = NOISE_COLLECT_T
    env = ex.Pendulum(batch_size=B, tau=1e-4, control_state=["theta"], noise_mode="fast", device=DEVICE,
                      **NOISE_PENDULUM)
    _, s0 = env.vmap_reset(R.split(R.PRNGKey(SEED + 5, DEVICE), B))
    s0.reference.theta = torch.linspace(-1.5, 1.5, B, device=DEVICE)
    acts = aprbs(R.PRNGKey(SEED + 6, DEVICE), B, T, 1)
    col = RolloutCollector(env)
    K.KERNEL.reset_counts()
    t0 = time.perf_counter()
    batch_f, final_f = col.collect_fused(s0, acts)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) * 1e3
    if K.KERNEL.launches["step"] != 1 or sum(K.KERNEL.launches.values()) != 1:
        raise AssertionError(f"collect_fused on the noisy Pendulum made {K.KERNEL.launches} launches, not one")
    t0 = time.perf_counter()
    batch_s, final_s = col.collect(s0, acts)
    torch.cuda.synchronize()
    collect_ms = (time.perf_counter() - t0) * 1e3
    held(f"noisy Pendulum fast mode B={B} T={T}",
         collect_deviations(batch_f, final_f, batch_s, final_s, ("theta", "omega")), batch_s, final_s)
    log_c(f"noisy Pendulum fast mode: collect_fused {fused_ms!r} ms, eager collect {collect_ms!r} ms (one run "
          f"each, the draws included)")
    del batch_f, final_f, batch_s, final_s

    # -- collect_policy: a Gaussian-exploration PD law drawing from each step's key
    T = POLICY_COLLECT_T
    env = ex.Pendulum(batch_size=B, tau=1e-4, control_state=["theta"], device=DEVICE)
    _, s0 = env.vmap_reset(R.split(R.PRNGKey(SEED + 7, DEVICE), B))
    s0.reference.theta = torch.linspace(-1.5, 1.5, B, device=DEVICE)

    def explore(obs, key):
        u = -0.9 * (obs[:, :1] - obs[:, 2:3]) - 0.25 * obs[:, 1:2]
        return torch.clamp(u + 0.1 * R.normal(key, (B, 1), torch.float32), -1.0, 1.0)

    t0 = time.perf_counter()
    batch_p, _ = RolloutCollector(env).collect_policy(explore, s0, R.PRNGKey(SEED + 8, DEVICE), T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(getattr(batch_p, n).float()).all()) for n in BATCH_LEAVES)
    log_c(f"collect_policy Gaussian PD B={B} T={T}: {wall * 1e3:.1f} ms (host clock) = {B * T / wall:.4e} "
          f"env-steps/s; mean reward {float(batch_p.rewards.mean())!r}; finite {finite}")
    if not finite:
        failures.append("collect_policy")
    del batch_p

    # -- adaptive integration: the stiff Van der Pol fleet
    Ba, N = ADAPTIVE_B, ADAPTIVE_INTERVALS
    mu = torch.exp(torch.linspace(math.log(1.0), math.log(300.0), Ba, device=DEVICE))
    vdp = ex.VanDerPol(batch_size=Ba, tau=5e-2, static_params={"mu": mu}, device=DEVICE)
    _, s0 = vdp.vmap_reset(R.split(R.PRNGKey(SEED, DEVICE), Ba))
    acts = torch.full((Ba, N, 1), 0.1, device=DEVICE)
    A.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, last_a, stats = A.adaptive_rollout(vdp, s0, acts, rtol=1e-6, atol=1e-8, max_steps_per_interval=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(A.COUNTS)
    acc, rej = stats.accepted.double(), stats.rejected.double()
    attempts = float((acc + rej).sum())
    incomplete = int(stats.incomplete.sum())
    fine = ex.VanDerPol(batch_size=Ba, tau=5e-2 / ADAPTIVE_FINE, static_params={"mu": mu}, solver="tsit5",
                        device=DEVICE)
    K.KERNEL.reset_counts()
    _, last_fine = fine.fused_rollout(s0, torch.repeat_interleave(acts, ADAPTIVE_FINE, dim=1), strict=True)
    torch.cuda.synchronize()
    fine_launches = K.KERNEL.launches["step"]
    dev = float((last_a.physical_state.position - last_fine.physical_state.position).abs().max())
    dev_v = float((last_a.physical_state.velocity - last_fine.physical_state.velocity).abs().max())
    # the velocity of a drive caught inside its relaxation jump is large and
    # moves fast, so its deviation is held against the fine rollout's scale
    v_scale = float(last_fine.physical_state.velocity.abs().max())
    _, last_fx = vdp.fused_rollout(s0, acts, strict=True)
    fx_dev = float(torch.nan_to_num((last_fx.physical_state.position - last_fine.physical_state.position).abs(),
                                    nan=math.inf).max())
    ok = (incomplete == 0 and dev <= 1e-3 and dev_v <= 1e-3 * v_scale and fine_launches == 1
          and all(bool(torch.isfinite(v).all()) for v in (last_a.physical_state.position,
                                                           last_a.physical_state.velocity)))
    log_c(f"adaptive_rollout VanDerPol mu 1..300 B={Ba}, {N} intervals of 5e-2, rtol 1e-6, atol 1e-8, float32: "
          f"{wall * 1e3:.1f} ms (host clock); accepted per instance min {int(acc.min())}, max {int(acc.max())}, "
          f"mean {float(acc.mean()):.2f}, rejected mean {float(rej.mean()):.2f}, spread "
          f"{float(acc.max() / acc.min().clamp(min=1)):.1f}x, incomplete {incomplete}; {counts['iterations']} loop "
          f"iterations, {counts['syncs']} condition reads ({counts['syncs'] / N:.1f} per interval); "
          f"{attempts * TSIT5_NEW_STAGES / wall:.4e} embedded-pair stages/s of accepted and rejected attempts, "
          f"{counts['iterations'] * Ba * TSIT5_NEW_STAGES / wall:.4e} evaluated (masked lanes included); "
          f"deviation from the {ADAPTIVE_FINE}x-fine Tsit5 fused_rollout ({fine_launches} launch): position "
          f"{dev!r} (limit 1e-3), velocity {dev_v!r} (limit 1e-3 of the largest |velocity| {v_scale!r}); one "
          f"fixed Euler step per tau: position {fx_dev!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("adaptive VanDerPol")

    # -- adaptive integration: the stiff mass-spring-damper fleet, k over 1..1e6
    ks = torch.exp(torch.linspace(0.0, math.log(1e6), Ba, device=DEVICE))
    msd = ex.MassSpringDamper(batch_size=Ba, tau=2e-3, static_params={"k": ks, "d": 0.2, "m": 1.0}, device=DEVICE)
    _, s0 = msd.vmap_reset(R.split(R.PRNGKey(SEED + 1, DEVICE), Ba))
    acts = torch.full((Ba, N, 1), 0.05, device=DEVICE)
    A.reset_counts()
    t0 = time.perf_counter()
    _, last_a, stats = A.adaptive_rollout(msd, s0, acts, rtol=1e-6, atol=1e-8, max_steps_per_interval=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, last_fx = msd.fused_rollout(s0, acts, strict=True)
    x_a = last_a.physical_state.deflection
    x_fx = torch.nan_to_num(last_fx.physical_state.deflection.abs(), nan=math.inf)
    adaptive_max, fixed_max = float(x_a.abs().max()), float(x_fx.max())
    incomplete = int(stats.incomplete.sum())
    ok = bool(torch.isfinite(x_a).all()) and incomplete == 0 and fixed_max > 10 * adaptive_max
    log_c(f"adaptive_rollout MassSpringDamper k 1..1e6 B={Ba}, {N} intervals of 2e-3: {wall * 1e3:.1f} ms; accepted "
          f"min {int(stats.accepted.min())}, max {int(stats.accepted.max())}, incomplete {incomplete}, "
          f"{A.COUNTS['syncs'] / N:.1f} condition reads per interval; largest |deflection| adaptive "
          f"{adaptive_max!r}, one fixed Euler step per tau {fixed_max!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("adaptive MassSpringDamper")

    # -- the PMSM's own interval loop on a per-batch r_s fleet
    Bp = ADAPTIVE_PMSM_B
    drive = randomize.randomize_env(ex.PMSM, R.PRNGKey(3, DEVICE), {"r_s": randomize.Uniform(15e-3, 21e-3)},
                                    batch_size=Bp, defaults=defaults, saturated=True,
                                    motor_variant=ex.MotorVariant.BRUSA, device=DEVICE)
    _, s0 = drive.vmap_reset(R.split(R.PRNGKey(SEED + 2, DEVICE), Bp))
    acts = aprbs(R.PRNGKey(SEED + 9, DEVICE), Bp, N, 2, hold_min=1, hold_max=4, minval=-0.4, maxval=0.4)
    A.reset_counts()
    t0 = time.perf_counter()
    obs, last_a, stats = A.adaptive_rollout(drive, s0, acts, rtol=1e-6, atol=1e-8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    incomplete = int(stats.incomplete.sum())
    ok = bool(torch.isfinite(obs).all()) and incomplete == 0
    log_c(f"adaptive_rollout saturated BRUSA, r_s per drive, B={Bp}, {N} intervals: {wall * 1e3:.1f} ms; accepted "
          f"min {int(stats.accepted.min())}, max {int(stats.accepted.max())}, rejected mean "
          f"{float(stats.rejected.double().mean()):.2f}, incomplete {incomplete}, finite {ok}")
    if not ok:
        failures.append("adaptive PMSM")
    if failures:
        raise AssertionError(f"data generation failed: {failures}")
    return entries


# ---------------------------------------------------------------------------
# estimation, planning and output-feedback control (utils/estimate.py,
# utils/mpc.py, utils/ofc.py)
# ---------------------------------------------------------------------------

# benchmarks/r03/mpc_fused_device.py:54-68 (the PMSM and Pendulum sweeps),
# ofc_pmsm_device.py:26-47, estimate_pmsm_device.py:27-33, foc_device.py
PLAN_PMSM_B, PLAN_PMSM_STEPS = 512, 32
PLAN_PMSM_CFG = dict(horizon=16, n_samples=64, temperature=0.05, noise_sigma=0.3, smoothing=0.5)
PLAN_PENDULUM_B, PLAN_PENDULUM_STEPS = 4096, 16
PLAN_PENDULUM_CFG = dict(horizon=32, n_samples=64, noise_sigma=0.5, smoothing=0.5)
PLAN_TRACK_B, PLAN_TRACK_STEPS = 512, 40  # tests/test_mpc.py:210's drive
PLAN_TRACK_CFG = dict(horizon=8, n_samples=32, temperature=0.02, noise_sigma=0.3, n_iterations=1, smoothing=0.3)
FILTER_B, FILTER_T = 2048, 512  # estimate_pmsm_device.py:27-33's 2,048 steps cut to 512
#: the drive's electrical speed in the filter case, pinned: under the
#: script's open-loop excitation, explicit Euler's current dynamics diverge
#: at the upper speeds of a random reset (normalized currents beyond 1e12
#: within 512 steps), where float32 keeps no digit of the truth
FILTER_OMEGA = 600.0
UKF_T = 300  # tests/test_estimate.py:18
FILTER_CPU_B = 8
#: the output-feedback FOC's steps, cut from tests/test_foc.py's 4,000 to
#: keep the script's phases under ~700 s: from rest the flux needs ~0.3 s
#: (tau_r ~ 103 ms) to come within the case's 6% of its setpoint
FOC_OFC_B, FOC_OFC_STEPS = 4096, 3000
OFC_PMSM_B, OFC_PMSM_STEPS = 512, 64
OFC_PMSM_CFG = dict(horizon=8, n_samples=32, temperature=0.02, noise_sigma=0.3, n_iterations=1, smoothing=0.3)
#: float32 on the card against float64 on the CPU, per leaf, over the leaf's
#: largest magnitude: the filters' float32 rounding over a few hundred steps
FILTER_CPU_LIMIT = 1e-3


def tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def scaled_deviation(a, b):
    """``max |a - b|`` over ``max |b|`` (both moved to the CPU in float64)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def phase_plan(ex, K, PK):
    """Estimation, planning and output-feedback control on the card, float32,
    at the JAX package's device-script widths: MPPI through the fused backend
    (one launch of ``csrc/pmsm_stepper.cu`` per iteration on saturated BRUSA,
    B = 512 x 64 samples x 16 steps, row 3f; one launch of ``csrc/stepper.cu``
    on the tracking Pendulum, B = 4,096 x 64 x 32, ``fused=True``, row 1l),
    each against the scan backend from the same key (0.0 apart), its kernel
    0.0 from its plain version on one sweep, the kernel, the candidate
    rollout, one MPPI iteration and its parts timed; ``tests/test_mpc.py:210``'s
    current control at B = 512; ``run_ekf`` on the noisy linear drive (B =
    2,048 x T = 512, at ``FILTER_OMEGA``) and ``run_ukf`` on the noisy
    Pendulum (B = 2,048 x T = 300),
    the filtered error below the raw sensor's and the first 8 trajectories
    against a float64 CPU run; the sensorless FOC of the induction machine
    through ``run_output_feedback_controller`` (B = 4,096 x 3,000 steps,
    flux and torque at their setpoints); and ``run_output_feedback_mppi`` on
    the noisy linear drive in ``ofc_pmsm_device.py``'s operating band (B =
    512 x 64 steps) beating its zero plan.
    Returns the kernel table's entries."""
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.utils import estimate, mpc, ofc
    from exciting_environments_torch.utils.episodes import reset_with_references
    from exciting_environments_torch.utils.foc import make_sensorless_foc

    card = card_line()
    entries, failures = [], []

    def log_p(msg):
        log(f"[plan] {msg} ({card})")

    def launches():
        return sum(K.KERNEL.launches.values()) + sum(PK.KERNEL.launches.values())

    def reset_counts():
        K.KERNEL.reset_counts()
        PK.KERNEL.reset_counts()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- MPPI through the fused backend against the scan (rows 3f and 1l)
    for row, name, lib, mode in (("3f", "brusa", PK, "pmsm_step"), ("1l", "pendulum", K, "step")):
        if name == "brusa":
            B, n_steps, cfg, fused = PLAN_PMSM_B, PLAN_PMSM_STEPS, mpc.MPPIConfig(**PLAN_PMSM_CFG), None
            env = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA,
                          control_state=["i_d", "i_q"], device=DEVICE)
        else:
            B, n_steps, cfg, fused = PLAN_PENDULUM_B, PLAN_PENDULUM_STEPS, mpc.MPPIConfig(**PLAN_PENDULUM_CFG), True
            env = ex.Pendulum(batch_size=B, tau=2e-2, control_state=["theta"], device=DEVICE)
        _, state = reset_with_references(env, R.PRNGKey(SEED + 20, DEVICE))
        key = R.PRNGKey(SEED + 21, DEVICE)
        label = f"row {row} MPPI {name} B={B} x {cfg.n_samples} samples x horizon {cfg.horizon}, {n_steps} steps"
        reset_counts()
        res_f, wall_f = timed(lambda: mpc.run_mppi(env, state, n_steps, key, cfg, fused=fused))
        n_launch, n_all = lib.KERNEL.launches[mode], launches()
        if n_launch != n_steps * cfg.n_iterations or n_all != n_launch:
            failures.append(f"{label}: {n_launch} launches of {mode} and {n_all} in all, not one per iteration")
        reset_counts()
        res_s, wall_s = timed(lambda: mpc.run_mppi(env, state, n_steps, key, cfg, fused=False))
        if launches():
            failures.append(f"{label}: the scan backend launched a kernel")
        devs = {n: leaf_deviation(getattr(res_f, n), getattr(res_s, n)) for n in ("actions", "rewards", "plan")}
        if any(d != 0.0 for d in devs.values()):
            failures.append(f"{label}: fused vs scan {devs}")
        finite = all(bool(torch.isfinite(getattr(res_f, n)).all()) for n in ("actions", "rewards", "plan"))
        if not finite:
            failures.append(f"{label}: non-finite result")
        # one sweep: the candidates of the first iteration, kernel against plain
        K_s, H = cfg.n_samples, cfg.horizon
        plan0 = torch.zeros((B, H, env.action_dim), dtype=env.dtype, device=DEVICE)
        k_it = R.split(key, cfg.n_iterations)[0]
        sigma = torch.as_tensor(cfg.noise_sigma, dtype=env.dtype, device=DEVICE).broadcast_to((env.action_dim,))
        draws = lambda: mpc._smooth_noise(R.normal(k_it, (K_s, B, H, env.action_dim), env.dtype), cfg.smoothing)
        cand = torch.clamp(plan0[None] + draws() * sigma, -1.0, 1.0)
        big, state_big = mpc._tile_env(env, K_s), mpc._tile_state(state, K_s)
        cand_flat = cand.reshape(K_s * B, H, env.action_dim)
        if name == "brusa":
            state0, omega = PK._start(state_big)
            kernel_fn = lambda: PK.pmsm_kernel_rollout(big, cand_flat, state0, omega, tau=big.tau, obs_stride=1,
                                                       batch_major=True)
            plain_fn = lambda: PK.plain_pmsm_rollout(big, cand_flat, state0, omega, tau=big.tau, obs_stride=1,
                                                     batch_major=True)
            entry_fn = lambda: PK.pmsm_fused_rollout(big, state_big, cand_flat, obs_stride=1,
                                                     return_traj_states=True, strict=True)
            inputs = [cand_flat, *state0, omega, big._lut.interleaved()]
            ops = pmsm_ops(big, big._solver, H, H) * K_s * B
            source, replaces = PMSM_SOURCE, PMSM_REPLACES
        else:
            y0 = tuple(getattr(state_big.physical_state, n) for n in big._ode_state_fields)
            kernel_fn = lambda: K.kernel_rollout(big, y0, cand_flat, tau=big.tau, obs_stride=1, batch_major=True)
            plain_fn = lambda: K.plain_rollout(big, y0, cand_flat.transpose(0, 1), tau=big.tau, obs_stride=1)
            entry_fn = lambda: K.env_fused_rollout(big, state_big, cand_flat, obs_stride=1, return_traj_states=True,
                                                   strict=True)
            inputs = [cand_flat, *y0]
            ops = ops_per_step(big, big._solver, False) * K_s * B * H
            source, replaces = SOURCE, REPLACES
        flat = lambda out: [t for part in out if part is not None for t in part if t is not None]
        outk, outp = flat(kernel_fn()), flat(plain_fn())
        torch.cuda.synchronize()
        kernel_err = max_abs(outk, outp)
        if kernel_err != 0.0:
            failures.append(f"{label}: kernel vs plain {kernel_err!r}")
        nbytes = tensor_bytes(inputs) + tensor_bytes(outk)
        bound_ms, bound_by = roofline(nbytes, ops)
        del outp
        use_fused = fused if fused is not None else name == "brusa"
        kernel_ms = time_ms(kernel_fn)
        kernel_ten_ms = time_ms(kernel_fn, chain=10)
        entry_ms = time_ms(entry_fn)
        plain_ms = time_ms(plain_fn, reps=1, warmup=0)
        cost_ms = time_ms(lambda: mpc._candidate_costs(env, state, cand, None, True))
        iteration_ms = time_ms(lambda: mpc.mppi_plan(env, state, plan0, key, cfg, fused=use_fused))
        scan_iteration_ms = time_ms(lambda: mpc.mppi_plan(env, state, plan0, key, cfg, fused=False), reps=3)
        draws_ms = time_ms(draws)
        _, traj_state, _ = entry_fn()
        props = big._props_for(big.env_properties, 1)
        reward_ms = time_ms(lambda: -torch.sum(big.generate_reward(traj_state, cand_flat, props).reshape(K_s * B, -1),
                                               dim=1))
        costs = mpc._candidate_costs(env, state, cand, None, True)
        cost_dev = leaf_deviation(costs, mpc._candidate_costs(env, state, cand, None, False))
        if cost_dev != 0.0:
            failures.append(f"{label}: the first iteration's costs, fused vs scan, {cost_dev!r}")
        softmax_ms = time_ms(lambda: torch.einsum("kb,kbha->bha", torch.softmax(-costs / cfg.temperature, dim=0),
                                                  cand))
        del traj_state, cand, cand_flat, big, state_big
        log_p(f"{label} float32: fused (kernel) {wall_f * 1e3:.1f} ms = {wall_f / n_steps * 1e3:.2f} ms per control "
              f"step, {n_launch / n_steps:g} launches per step; scan {wall_s * 1e3:.1f} ms = "
              f"{wall_s / n_steps * 1e3:.2f} ms per step, 0 launches (host clock, one run each); fused vs scan "
              f"{devs}; one MPPI iteration: fused {iteration_ms!r} ms, scan {scan_iteration_ms!r} ms (CUDA events); "
              f"its parts: draws and smoothing {draws_ms!r} ms, the candidate rollout {entry_ms!r} ms (the kernel "
              f"alone {kernel_ms!r} ms, {kernel_ten_ms!r} ms per call over ten back to back), the eager reward {reward_ms!r} ms, softmax and weighted mean "
              f"{softmax_ms!r} ms; the candidates' costs {cost_ms!r} ms (fused vs scan {cost_dev!r}); kernel vs "
              f"plain max abs {kernel_err!r}, "
              f"plain {plain_ms!r} ms; bound {bound_ms!r} ms ({bound_by}: {nbytes / 1e6:.1f} MB of candidates, "
              f"start leaves{', table' if name == 'brusa' else ''} and saves; {ops:.4e} operations), "
              f"{bound_ms / kernel_ms:.1%} of it")
        entries.append(entry(f"{'pmsm_stepper' if name == 'brusa' else 'stepper'}_mppi", n_launch, kernel_err,
                             kernel_ms, plain_ms, bound_ms, bound_by, source, replaces))
        del res_f, res_s

    # -- tests/test_mpc.py:210: MPPI current control of saturated BRUSA
    B = PLAN_TRACK_B
    env = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, control_state=["i_d", "i_q"],
                  tau=1e-4, device=DEVICE)
    _, state = reset_with_references(env, R.PRNGKey(7, DEVICE))
    cfg = mpc.MPPIConfig(**PLAN_TRACK_CFG)
    reset_counts()
    res, wall = timed(lambda: mpc.run_mppi(env, state, PLAN_TRACK_STEPS, R.PRNGKey(8, DEVICE), cfg))
    n_launch = launches()
    _, rew_zero, _ = mpc._rollout(env, state, torch.zeros((B, PLAN_TRACK_STEPS, 2), device=DEVICE))
    settled, mean, zero = float(res.rewards[:, 20:].mean()), float(res.rewards.mean()), float(rew_zero.mean())
    ok = settled > -0.05 and mean > zero + 1.0 and n_launch == PLAN_TRACK_STEPS
    log_p(f"MPPI current control, saturated BRUSA B={B}, {PLAN_TRACK_STEPS} steps (auto: the PMSM kernel): "
          f"{wall * 1e3:.1f} ms = {wall / PLAN_TRACK_STEPS * 1e3:.2f} ms per step, {n_launch / PLAN_TRACK_STEPS:g} "
          f"launches per step; settled mean reward {settled!r} (> -0.05), mean {mean!r} against the zero plan's "
          f"{zero!r} (+1.0 needed) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("MPPI current control")

    # -- EKF and UKF: the noisy linear drive and the noisy Pendulum
    B, T = FILTER_B, FILTER_T
    sig = {"i_d": 8.0, "i_q": 8.0}
    noisy = ex.PMSM(batch_size=B, saturated=False, observation_noise=sig, device=DEVICE)
    clean = ex.PMSM(batch_size=B, saturated=False, device=DEVICE)
    _, st = noisy.vmap_reset(R.split(R.PRNGKey(3, DEVICE), B))
    st.physical_state.omega_el = torch.full((B,), FILTER_OMEGA, device=DEVICE)
    t = torch.arange(T, device=DEVICE, dtype=torch.float64) * noisy.tau
    acts = (0.15 * torch.stack([torch.sin(300.0 * t), torch.cos(300.0 * t)], dim=-1)).float()[None].expand(B, T, 2)
    obs_noisy = noisy.vmap_rollout(st, acts)[0]
    obs_true = clean.vmap_rollout(st, acts)[0]
    names = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")
    fkw = dict(measured_fields=("i_d", "i_q", "omega_el"), process_std={"i_d": 1.0, "i_q": 1.0})
    cpu_env = ex.PMSM(batch_size=FILTER_CPU_B, saturated=False, observation_noise=sig, device="cpu",
                      dtype=torch.float64)
    half = T // 2
    reset_counts()
    res, wall = timed(lambda: estimate.run_ekf(noisy, obs_noisy, acts, **fkw))
    n_launch = launches()
    ref = estimate.run_ekf(cpu_env, obs_noisy[:FILTER_CPU_B].cpu(), acts[:FILTER_CPU_B].cpu(), **fkw)
    devs = {n: scaled_deviation(getattr(res, n)[:FILTER_CPU_B], getattr(ref, n)) for n in ("means", "covs")}
    gains = {}
    for field, col in (("i_d", 0), ("i_q", 1)):
        err = lambda x: float(torch.sqrt(torch.mean((x - obs_true[:, half:, col]) ** 2)))
        gains[field] = (err(res.means[:, half:, names.index(field)]), err(obs_noisy[:, half:, col]))
    ok = (all(f < 0.6 * r for f, r in gains.values()) and all(d <= FILTER_CPU_LIMIT for d in devs.values())
          and bool(torch.isfinite(res.means).all()) and n_launch == 0)
    log_p(f"run_ekf noisy linear PMSM (8 A on i_d, i_q, omega_el {FILTER_OMEGA}) B={B} T={T} float32: "
          f"{wall * 1e3:.1f} ms = {wall / T * 1e3:.2f} ms per filter step, {n_launch} launches; RMSE filtered / raw "
          f"(normalized) "
          + ", ".join(f"{k} {f:.3f} / {r:.3f}" for k, (f, r) in gains.items())
          + f" (below 0.6x needed); first {FILTER_CPU_B} against the float64 CPU run {devs} (limit "
          f"{FILTER_CPU_LIMIT}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("run_ekf on the drive")
    del res
    del obs_noisy, obs_true
    pend = ex.Pendulum(batch_size=B, tau=2e-2, observation_noise={"theta": 0.08}, device=DEVICE)
    pend_clean = ex.Pendulum(batch_size=B, tau=2e-2, device=DEVICE)
    _, st = pend.vmap_reset(R.split(R.PRNGKey(7, DEVICE), B))
    t = torch.arange(UKF_T, device=DEVICE, dtype=torch.float64) * 2e-2
    acts = (0.3 * torch.sin(2.0 * t)).float()[None, :, None].expand(B, UKF_T, 1)
    obs_noisy = pend.vmap_rollout(st, acts)[0]
    obs_true = pend_clean.vmap_rollout(st, acts)[0]
    pkw = dict(measured_fields=("theta",), process_std={"omega": 0.05})
    res, wall = timed(lambda: estimate.run_ukf(pend, obs_noisy, acts, **pkw))
    cpu_pend = ex.Pendulum(batch_size=FILTER_CPU_B, tau=2e-2, observation_noise={"theta": 0.08}, device="cpu",
                           dtype=torch.float64)
    ref = estimate.run_ukf(cpu_pend, obs_noisy[:FILTER_CPU_B].cpu(), acts[:FILTER_CPU_B].cpu(), **pkw)
    devs = {n: scaled_deviation(getattr(res, n)[:FILTER_CPU_B], getattr(ref, n)) for n in ("means", "covs")}
    half = UKF_T // 2
    d = lambda a: a - 2.0 * torch.round(a / 2.0)
    theta_f = float(torch.sqrt(torch.mean(d(res.means[:, half:, 0] - obs_true[:, half:, 0]) ** 2)))
    theta_r = float(torch.sqrt(torch.mean(d(obs_noisy[:, half:, 0] - obs_true[:, half:, 0]) ** 2)))
    omega_f = float(torch.sqrt(torch.mean((res.means[:, half:, 1] - obs_true[:, half:, 1]) ** 2)))
    ok = theta_f < 0.7 * theta_r and omega_f < 0.06 and all(v <= FILTER_CPU_LIMIT for v in devs.values())
    log_p(f"run_ukf noisy Pendulum (0.08 rad) B={B} T={UKF_T} float32: {wall * 1e3:.1f} ms = "
          f"{wall / UKF_T * 1e3:.2f} ms per filter step ({5 * B} sigma points per step), 0 launches; theta RMSE "
          f"filtered {theta_f:.4f} / raw {theta_r:.4f} (below 0.7x needed), omega {omega_f:.4f} (< 0.06); first "
          f"{FILTER_CPU_B} against the float64 CPU run {devs} (limit {FILTER_CPU_LIMIT}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("run_ukf on the Pendulum")
    del res, obs_noisy, obs_true

    # -- output-feedback FOC of the induction machine (tests/test_foc.py:72)
    B, n_steps = FOC_OFC_B, FOC_OFC_STEPS
    plant = ex.InductionMachine(batch_size=B, observation_noise={"i_sd": 0.3, "i_sq": 0.3}, device=DEVICE)
    model = ex.InductionMachine(batch_size=B, device=DEVICE)
    _, st = plant.vmap_reset(R.split(R.PRNGKey(SEED, DEVICE), B))
    for field in ("i_sd", "i_sq", "psi_rd", "psi_rq"):
        setattr(st.physical_state, field, torch.zeros(B, device=DEVICE))
    ctrl, carry0 = make_sensorless_foc(model, psi_ref=0.7, torque_ref=8.0)
    reset_counts()
    res, wall = timed(lambda: ofc.run_output_feedback_controller(
        plant, model, st, n_steps, ctrl, controller_carry=carry0, measured_fields=("i_sd", "i_sq"),
        process_std={"psi_rd": 0.02, "psi_rq": 0.02}, x0=torch.zeros(4, device=DEVICE),
        return_trajectories=False))
    phys = res.final_state.physical_state
    psi = torch.sqrt(phys.psi_rd**2 + phys.psi_rq**2)
    torque = model.torque(res.final_state)
    psi_err, torque_err = float((psi / 0.7 - 1).abs().max()), float((torque / 8.0 - 1).abs().max())
    free = float(res.plan[3].float().mean())
    ok = psi_err <= 0.06 and torque_err <= 0.10 and launches() == 0
    log_p(f"run_output_feedback_controller sensorless FOC, IM B={B} from rest, 0.3 A sensors, {n_steps} steps, "
          f"float32: {wall * 1e3:.1f} ms = {wall / n_steps * 1e3:.3f} ms per control step, 0 launches; flux "
          f"{float(psi.min())!r}..{float(psi.max())!r} Vs (largest relative error {psi_err:.4f}, limit 0.06), torque "
          f"{float(torque.min())!r}..{float(torque.max())!r} Nm ({torque_err:.4f}, limit 0.10), inside the voltage "
          f"circle at the end {free:.2%}, mean NLL "
          f"{float(res.nll.mean())!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("output-feedback FOC")
    del res

    # -- output-feedback MPPI on the noisy linear drive (ofc_pmsm_device.py:26-47's
    # operating band: zero currents, a fifth of the reset's speeds, 0.3 of its
    # references; tests/test_ofc.py:136's checks)
    B = OFC_PMSM_B
    kw = dict(batch_size=B, control_state=["i_d", "i_q"], tau=1e-4, device=DEVICE)
    plant = ex.PMSM(observation_noise={"i_d": 8.0, "i_q": 8.0}, **kw)
    model = ex.PMSM(**kw)
    _, st = reset_with_references(plant, R.PRNGKey(0, DEVICE))
    st.physical_state.i_d = torch.zeros(B, device=DEVICE)
    st.physical_state.i_q = torch.zeros(B, device=DEVICE)
    st.physical_state.omega_el = 0.2 * st.physical_state.omega_el
    st.reference.i_d = 0.3 * st.reference.i_d
    st.reference.i_q = 0.3 * st.reference.i_q
    fkw = dict(measured_fields=("i_d", "i_q", "omega_el"), process_std={"i_d": 1.0, "i_q": 1.0})
    runs = {}
    for n_it in (1, 0):
        cfg = mpc.MPPIConfig(**dict(OFC_PMSM_CFG, n_iterations=n_it))
        reset_counts()
        runs[n_it] = timed(lambda: ofc.run_output_feedback_mppi(plant, model, st, OFC_PMSM_STEPS,
                                                                R.PRNGKey(1, DEVICE), cfg, **fkw)) + (launches(),)
    (res, wall, n_launch), (res0, _, _) = runs[1], runs[0]
    finite = all(bool(torch.isfinite(getattr(res, n)).all())
                 for n in ("observations", "actions", "rewards", "belief_means", "nll"))
    mean, zero, settled = float(res.rewards.mean()), float(res0.rewards.mean()), float(res.rewards[:, 20:].mean())
    # the test's margin (+0.5) is for its full-size references; on the 0.3-scaled
    # band the loop must cut the zero plan's tracking loss to a quarter
    ok = finite and -mean < 0.25 * -zero and settled > -0.1 and n_launch == 0
    log_p(f"run_output_feedback_mppi noisy linear PMSM (8 A) B={B}, horizon 8 x 32 samples, {OFC_PMSM_STEPS} steps, "
          f"float32: {wall * 1e3:.1f} ms = {wall / OFC_PMSM_STEPS * 1e3:.2f} ms per control step, 0 launches (the "
          f"scan backend); mean reward {mean!r} against the zero plan's {zero!r} (a quarter of its loss at most), "
          f"settled {settled!r} (> -0.1), finite {finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("output-feedback MPPI")
    if failures:
        raise AssertionError(f"planning failed: {failures}")
    return entries


IDENT_ILQR_B, IDENT_ILQR_H, IDENT_ILQR_ITERS = 4096, 32, 4  # benchmarks/r03/ilqr_device.py:25-27 (4 and 64 there)
IDENT_TAU, IDENT_TRUE = 1e-2, {"l": 1.3, "m": 0.8}  # benchmarks/r03/sysid_device.py:24-25
#: benchmarks/r03/sysid_device.py:26: 8,192 starts, 256 steps, segments of
#: 32; its 400 and 3,200 iterations cut to 50
IDENT_FIT_STARTS, IDENT_FIT_T, IDENT_FIT_SEG, IDENT_FIT_ITERS = 8192, 256, 32, 50
#: tests/test_sysid.py:165-182's drive: 256 steps, segments of 16; 64 starts, 50 iterations
IDENT_PMSM_STARTS, IDENT_PMSM_T, IDENT_PMSM_SEG, IDENT_PMSM_ITERS = 64, 256, 16, 50
IDENT_FIM_T = 256
IDENT_EXC_T, IDENT_EXC_ITERS = 48, 40  # tests/test_sysid.py:185-190
#: the first iteration's gradient, kernels' VJP against eager autograd, float32
IDENT_GRAD_LIMIT = 1e-5
#: the FIM on the card (float32) against a float64 CPU run, over its largest entry
IDENT_FIM_LIMIT = 1e-4


def phase_ident(ex, K, PK):
    """iLQR and system identification on the card, float32 (docstring item
    23).  Returns the kernel table's entries (rows 1m and 3g)."""
    from exciting_environments_torch.core import structures
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.ops.signals import aprbs
    from exciting_environments_torch.utils import ilqr, sysid
    from exciting_environments_torch.utils.episodes import reset_with_references

    card = card_line()
    entries, failures = [], []

    def log_i(msg):
        log(f"[ident] {msg} ({card})")

    def launches():
        return sum(K.KERNEL.launches.values()) + sum(PK.KERNEL.launches.values())

    def reset_counts():
        K.KERNEL.reset_counts()
        PK.KERNEL.reset_counts()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- iLQR on the tracking Pendulum (no kernel: the line search applies
    # time-varying feedback)
    B, H, n_it = IDENT_ILQR_B, IDENT_ILQR_H, IDENT_ILQR_ITERS
    env = ex.Pendulum(batch_size=B, tau=2e-2, control_state=["theta"], device=DEVICE)
    _, state = reset_with_references(env, R.PRNGKey(SEED, DEVICE))
    u0 = torch.zeros((B, H, 1), device=DEVICE)
    ilqr.ilqr_plan(env, state, u0, iterations=1)  # warm-up
    reset_counts()
    res, wall = timed(lambda: ilqr.ilqr_plan(env, state, u0, iterations=n_it))
    n_launch = launches()
    costs = res.costs.double().cpu()
    ok = (bool(torch.isfinite(costs).all()) and bool((torch.diff(costs) <= 0).all()) and costs[-1] < costs[0]
          and bool((res.actions.abs() <= 1.0).all()) and n_launch == 0)
    prob = ilqr._problem(env, state, 1e-4, None)
    alphas = torch.tensor((1.0, 0.3, 0.1, 0.03, 0.01), device=DEVICE)
    us = u0.transpose(0, 1)
    xs, J = ilqr._rollout_cost(prob, us)
    mu = torch.full((B,), 1e-3, device=DEVICE)
    lin = ilqr._linearize(prob.f, xs, us)
    quad = ilqr._grad_hessian(prob.stage, torch.cat([xs, us], dim=-1))
    gains = ilqr._backward_sweep(*lin, *quad, mu)
    parts = {
        "linearization": time_ms(lambda: ilqr._linearize(prob.f, xs, us), reps=3),
        "Hessians": time_ms(lambda: ilqr._grad_hessian(prob.stage, torch.cat([xs, us], dim=-1)), reps=3),
        "sweep": time_ms(lambda: ilqr._backward_sweep(*lin, *quad, mu), reps=3),
        "line search": time_ms(lambda: ilqr._line_search(prob, xs, us, *gains, alphas), reps=3),
    }
    iteration_ms = time_ms(lambda: ilqr._iteration(prob, xs, us, J, mu, alphas), reps=3)
    log_i(f"ilqr_plan tracking Pendulum B={B} horizon {H}, {len(alphas)} step sizes, {n_it} iterations, float32: "
          f"{wall * 1e3:.1f} ms = {wall / n_it * 1e3:.1f} ms per iteration (host clock, {n_launch} launches); one "
          f"iteration {iteration_ms!r} ms (CUDA events): "
          + ", ".join(f"{k} {v!r} ms" for k, v in parts.items())
          + f"; mean cost {costs.tolist()} (non-increasing, below its start), actions within [-1, 1] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("ilqr_plan")
    del res, lin, quad, gains, xs

    # -- multistart fits through the kernels: the Pendulum (row 1m) and the
    # linear PMSM (row 3g)
    def fit_case(row, env, true, guess, actions, starts, seg, iters, lib, mode, source, replaces):
        props = structures.replace(env.env_properties,
                                   static_params=structures.replace(env.env_properties.static_params, **true))
        init_state = env.init_state(props)
        recorded, _, _ = env.sim_ahead(init_state, actions, props, env.tau, env.tau)
        kw = dict(init_state=init_state, n_starts=starts, segment_length=seg, spread=0.5)
        sysid.fit_parameters(env, actions, recorded, guess, iterations=2, **kw)  # warm-up
        label = (f"row {row} fit_parameters {type(env).__name__} {list(guess)}: {starts} starts x "
                 f"{actions.shape[0] // seg} segments of {seg} steps, {iters} iterations")
        reset_counts()
        fit, fit_wall = timed(lambda: sysid.fit_parameters(env, actions, recorded, guess, iterations=iters, **kw))
        n_launch, n_all = lib.KERNEL.launches[mode], launches()
        if n_launch != iters + 1 or n_all != n_launch:
            failures.append(f"{label}: {n_launch} launches of {mode} and {n_all} in all, not one per iteration "
                            "and one for the final check")
        rel = {n: abs(fit.params[n] - v) / v for n, v in true.items()}
        hist = fit.losses.double().cpu()
        if not (bool(torch.isfinite(hist).all()) and hist[-1] < hist[0] and math.isfinite(fit.final_loss)):
            failures.append(f"{label}: the loss did not fall ({hist[0].item()!r} -> {hist[-1].item()!r})")
        # the first iteration's gradient: the kernels' VJP against eager autograd
        theta0, _, losses = sysid._fit_problem(env, actions, recorded, guess, init_state, env.tau, env.tau, starts,
                                               0.5, None, "log", seg, R.PRNGKey(0, DEVICE))
        grads = []
        for eager in (False, True):
            theta = theta0.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(losses(theta, eager=eager).sum(), theta)
            grads.append(g)
        grad_dev = scaled_deviation(grads[0], grads[1])
        if not grad_dev <= IDENT_GRAD_LIMIT:
            failures.append(f"{label}: gradient {grad_dev!r} from eager autograd")
        # one sweep: the kernel against its plain version on the fit's batch
        names = tuple(guess)
        n_seg = actions.shape[0] // seg
        values = torch.exp(theta0).repeat_interleave(n_seg, dim=0)
        shadow = sysid._batched_env(env, names, values)
        seg_states = sysid._with_first(env.generate_state_from_observation(
            recorded[torch.arange(n_seg, device=DEVICE) * seg], env.env_properties), init_state)
        states = sysid._tile_state(seg_states, starts)
        acts = actions[: n_seg * seg].reshape(n_seg, seg, -1).repeat(starts, 1, 1)
        N = starts * n_seg
        if lib is PK:
            state0, omega = PK._start(states)
            kernel_fn = lambda: PK.pmsm_kernel_rollout(shadow, acts, state0, omega, tau=env.tau, obs_stride=1,
                                                       sim_ahead=True, batch_major=True)
            plain_fn = lambda: PK.plain_pmsm_rollout(shadow, acts, state0, omega, tau=env.tau, obs_stride=1,
                                                     sim_ahead=True, batch_major=True)
            inputs = [acts, *state0, omega] + [getattr(shadow.env_properties.static_params, n) for n in names]
            ops = pmsm_ops(shadow, shadow._solver, seg, seg) * N
        else:
            y0 = tuple(getattr(states.physical_state, n) for n in shadow._ode_state_fields)
            kernel_fn = lambda: K.kernel_rollout(shadow, y0, acts, tau=env.tau, obs_stride=1, sim_ahead=True,
                                                 batch_major=True)
            plain_fn = lambda: K.plain_rollout(shadow, y0, acts.transpose(0, 1), tau=env.tau, obs_stride=1,
                                               sim_ahead=True)
            inputs = [acts, *y0] + [getattr(shadow.env_properties.static_params, n) for n in names]
            ops = ops_per_step(shadow, shadow._solver, True) * N * seg
        flat = lambda out: [t for part in out if part is not None for t in part if t is not None]
        with torch.no_grad():
            outk, outp = flat(kernel_fn()), flat(plain_fn())
            torch.cuda.synchronize()
            kernel_err = max_abs(outk, outp)
            if kernel_err != 0.0:
                failures.append(f"{label}: kernel vs plain {kernel_err!r}")
            nbytes = tensor_bytes(inputs) + tensor_bytes(outk)
            bound_ms, bound_by = roofline(nbytes, ops)
            del outp
            kernel_ms = time_ms(kernel_fn)
            kernel_ten_ms = time_ms(kernel_fn, chain=10)
            plain_ms = time_ms(plain_fn, reps=1, warmup=0)
            loss_ms = time_ms(lambda: losses(theta0))
        theta = theta0.detach().requires_grad_(True)

        def forward():
            with torch.enable_grad():
                return losses(theta).sum()

        forward_ms = time_ms(forward, reps=3)
        step_ms = time_ms(lambda: torch.autograd.grad(forward(), theta), reps=3)
        iteration_ms = fit_wall / (iters + 1) * 1e3
        log_i(f"{label}, float32: {fit_wall * 1e3:.1f} ms = {iteration_ms:.2f} ms per iteration (host clock), "
              f"{n_launch} launches of {mode} ({iters} iterations and the final check); parameters "
              + ", ".join(f"{n} {fit.params[n]!r} (true {v}, relative error {rel[n]:.3e})" for n, v in true.items())
              + f"; loss {hist[0].item()!r} -> {fit.final_loss!r}; first gradient against eager autograd "
              f"{grad_dev!r} (limit {IDENT_GRAD_LIMIT}); per iteration (CUDA events): the kernel {kernel_ms!r} ms "
              f"({kernel_ten_ms!r} ms per call over ten back to back), "
              f"the loss without grad {loss_ms!r} ms, the forward with saves {forward_ms!r} ms, forward and VJP "
              f"replay {step_ms!r} ms (the replay {step_ms - forward_ms!r} ms), the rest (optimizer, "
              f"best-iterate tracking, host) {iteration_ms - step_ms:.3f} ms; kernel vs plain max abs {kernel_err!r}, plain {plain_ms!r} ms; "
              f"bound {bound_ms!r} ms ({bound_by}: {nbytes / 1e6:.1f} MB of slab, start leaves, per-batch "
              f"parameters, finals and the saves every step that are the VJP's checkpoints; {ops:.4e} "
              f"operations), {bound_ms / kernel_ms:.1%} of it")
        entries.append(entry(f"{'pmsm_stepper' if lib is PK else 'stepper'}_sysid_fit", n_launch, kernel_err,
                             kernel_ms, plain_ms, bound_ms, bound_by, source, replaces))

    env = ex.Pendulum(batch_size=1, tau=IDENT_TAU, device=DEVICE)
    actions = aprbs(R.PRNGKey(0, DEVICE), 1, IDENT_FIT_T, 1, hold_min=5, hold_max=20)[0]
    fit_case("1m", env, IDENT_TRUE, {"l": 1.0, "m": 1.0}, actions, IDENT_FIT_STARTS, IDENT_FIT_SEG,
             IDENT_FIT_ITERS, K, "sim_ahead", SOURCE, REPLACES)
    drive = ex.PMSM(batch_size=1, device=DEVICE)
    sp = drive.env_properties.static_params
    true = {"r_s": float(sp.r_s) * 1.4, "l_d": float(sp.l_d) * 0.75, "l_q": float(sp.l_q) * 1.2}
    guess = {"r_s": float(sp.r_s), "l_d": float(sp.l_d), "l_q": float(sp.l_q)}
    actions = aprbs(R.PRNGKey(0, DEVICE), 1, IDENT_PMSM_T, 2, hold_min=3, hold_max=12)[0]
    fit_case("3g", drive, true, guess, actions, IDENT_PMSM_STARTS, IDENT_PMSM_SEG, IDENT_PMSM_ITERS, PK,
             "pmsm_sim_ahead", PMSM_SOURCE, PMSM_REPLACES)

    # -- the Fisher information and D-optimal excitation on the Pendulum
    env = ex.Pendulum(batch_size=1, tau=IDENT_TAU, device=DEVICE)
    excitation = aprbs(R.PRNGKey(1, DEVICE), 1, IDENT_FIM_T, 1, hold_min=4, hold_max=12)[0]
    reset_counts()
    fim, fim_wall = timed(lambda: sysid.fisher_information(env, excitation, ("l", "m")))
    n_launch = K.KERNEL.launches["sim_ahead"]
    fim_ms = time_ms(lambda: sysid.fisher_information(env, excitation, ("l", "m")), reps=3)
    cpu = ex.Pendulum(batch_size=1, tau=IDENT_TAU, device="cpu", dtype=torch.float64)
    fim_cpu = sysid.fisher_information(cpu, excitation.double().cpu(), ("l", "m"))
    fim_dev = scaled_deviation(fim.fim, fim_cpu.fim)
    ok = (fim_dev <= IDENT_FIM_LIMIT and n_launch == 1 and float(torch.linalg.det(fim.fim.double())) > 0
          and bool(torch.isfinite(fim.crlb).all()))
    n_out = (IDENT_FIM_T + 1) * len(env.obs_description)
    log_i(f"fisher_information Pendulum {IDENT_FIM_T} steps, ('l', 'm'), float32: {fim_ms!r} ms per call (CUDA "
          f"events; first call {fim_wall * 1e3:.1f} ms host clock), {n_launch} launch of the stepper kernel over "
          f"{n_out} sensitivity copies and their VJP; FIM {fim.fim.tolist()} against the float64 CPU run "
          f"{fim_dev!r} (limit {IDENT_FIM_LIMIT}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("fisher_information")
    init = 0.05 * R.normal(R.PRNGKey(2, DEVICE), (IDENT_EXC_T, 1), torch.float32)
    before = sysid.fisher_information(env, init, ("l", "m"))
    reset_counts()
    exc, exc_wall = timed(lambda: sysid.optimize_excitation(env, ("l", "m"), IDENT_EXC_T, init_actions=init,
                                                            iterations=IDENT_EXC_ITERS))
    n_launch = launches()
    gain = float(torch.linalg.slogdet(exc.fisher.fim.double())[1] - torch.linalg.slogdet(before.fim.double())[1])
    obj = exc.objectives.double().cpu()
    ok = (gain > 1.0 and bool(torch.isfinite(obj).all()) and obj[-1] > obj[0]
          and float(exc.actions.abs().max()) <= 1.0)
    log_i(f"optimize_excitation Pendulum {IDENT_EXC_T} steps x {IDENT_EXC_ITERS} iterations, D-criterion, float32 "
          f"(eager vmap_sim_ahead, create_graph): {exc_wall * 1e3:.1f} ms = {exc_wall / IDENT_EXC_ITERS * 1e3:.1f} ms "
          f"per iteration (host clock), {n_launch} launch (the final FIM); objective {obj[0].item()!r} -> "
          f"{obj[-1].item()!r}, log det gain {gain!r} (> 1) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("optimize_excitation")
    if failures:
        raise AssertionError(f"identification failed: {failures}")
    return entries


# ---------------------------------------------------------------------------
# the batch split (parallel/mesh.py) and the wrappers
# ---------------------------------------------------------------------------

SHARD_DEVICES = ["cuda:0"] * 4  # four shards on the one card
T_SHARD_PCL = 2048


def tree_gap(a, b):
    """max |a - b| over the leaves of two trees of one structure
    (``leaf_deviation`` per tensor; other leaves must be equal)."""
    from exciting_environments_torch.core import structures

    la, lb = structures.leaves(a), structures.leaves(b)
    if len(la) != len(lb):
        raise AssertionError("the split and unsplit results have different structures")
    gap = 0.0
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            gap = max(gap, leaf_deviation(x, y) if x.dtype == y.dtype else math.inf)
        elif x != y and not (x != x and y != y):
            return math.inf
    return gap


def phase_shard(ex, K, PK, CL, PCL):
    """The batch split over four shards of one card (``parallel/mesh.py``,
    ``make_batch_mesh(["cuda:0"] * 4)``), B = 65,536, float32: the Pendulum
    ``fused_rollout`` over T = 4,096 (kernel 1), a saturated BRUSA fleet with
    per-drive ``r_s`` over T = 256 (kernel 3), the PD closed loop over
    T = 4,096 (kernel 2) and the BRUSA PI closed loop with per-drive
    ``u_dc`` over T = 2,048 (kernel 4).  Each split call makes one launch per
    shard (the counts set to 0 just before it, read just after), equals the
    unsplit call at 0.0 in every leaf and its plain version at 0.0; the split
    and unsplit entry points are timed (CUDA-event medians of 5), with the
    peak memory of each.  Returns the kernel table's rows 1n, 2j, 3h and 4f."""
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.parallel import ShardedEnv, make_batch_mesh
    from exciting_environments_torch.utils import randomize

    card = card_line()
    mesh = make_batch_mesh(SHARD_DEVICES)
    n = mesh.size
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 60)
    B = B_MAIN
    entries = []

    def log_s(msg):
        log(f"[shard] {msg} ({card})")

    def run_case(name, env, senv, split_fn, whole_fn, plain_fn, plain_ref, counter, mode, bound_ms, bound_by, source,
                 replaces, n_steps):
        counter.reset_counts()
        split = split_fn(senv)
        torch.cuda.synchronize()
        launches = counter.launches[mode]
        if launches != n:
            raise AssertionError(f"{name}: the split call made {launches} {mode} launches, not {n}")
        whole = whole_fn(env)
        gap = tree_gap(split, whole)
        t0 = time.perf_counter()
        plain = plain_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs(plain_ref(split), plain)
        del plain
        if gap != 0.0 or err != 0.0:
            raise AssertionError(f"{name}: split vs unsplit {gap!r}, split vs plain {err!r}")
        split_ms = time_ms(lambda: split_fn(senv))
        whole_ms = time_ms(lambda: whole_fn(env))
        split_mem = extra_memory(lambda: split_fn(senv))
        whole_mem = extra_memory(lambda: whole_fn(env))
        log_s(f"{name}: {launches} launches ({launches // n} per shard); split {split_ms!r} ms, unsplit "
              f"{whole_ms!r} ms ({split_ms / whole_ms:.3f} x); peak memory beyond the inputs split {split_mem} B, "
              f"unsplit {whole_mem} B; split vs unsplit {gap!r}, vs plain {err!r}; plain {plain_ms!r} ms (one run); "
              f"bound {bound_ms!r} ms ({bound_by}), {bound_ms / split_ms:.1%} of it; "
              f"{B * n_steps / split_ms * 1e3:.4e} env-steps/s")
        entries.append(entry(name, launches, err, split_ms, plain_ms, bound_ms, bound_by, source, replaces))

    # kernel 1: the Pendulum's open loop, batch-major slab (each shard's rows read in place)
    T = T_MAIN
    env = ex.Pendulum(batch_size=B, tau=1e-4, device=DEVICE)
    _, state = env.vmap_reset(rng=gen)
    acts_bm = random_actions(env, T, gen).transpose(0, 1).contiguous()
    senv = ShardedEnv(env, mesh)
    y0 = tuple(getattr(state.physical_state, f) for f in env._ode_state_fields)
    run_case("stepper_step_split4", env, senv, lambda e: e.fused_rollout(state, acts_bm, strict=True),
             lambda e: e.fused_rollout(state, acts_bm, strict=True),
             lambda: K.plain_rollout(env, y0, acts_bm.transpose(0, 1), tau=env.tau)[0],
             lambda out: tuple(getattr(out[1].physical_state, f) for f in env._ode_state_fields), K.KERNEL, "step",
             *bound(env, env._solver, B, T, T, 0, False), SOURCE, REPLACES, T)
    del acts_bm

    # kernel 3: a BRUSA fleet whose r_s differs per drive
    Tp = T_PMSM
    defaults = dict(ex.MotorVariant.BRUSA.get_params().static_params.__dict__)
    fleet = randomize.randomize_env(ex.PMSM, R.PRNGKey(SEED + 61, DEVICE),
                                    {"r_s": randomize.Uniform(15e-3, 21e-3)}, batch_size=B, defaults=defaults,
                                    saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4, device=DEVICE)
    r_s = fleet.env_properties.static_params.r_s
    if not isinstance(r_s, torch.Tensor) or float(r_s.max() - r_s.min()) <= 0.0:
        raise AssertionError("the fleet's r_s is not per drive")
    pstate, acts_tm = pmsm_inputs(fleet, Tp, gen, lim=0.3)
    pacts = acts_tm.transpose(0, 1).contiguous()
    sfleet = ShardedEnv(fleet, mesh)
    run_case("pmsm_step_split4", fleet, sfleet, lambda e: e.fused_rollout(pstate, pacts, strict=True),
             lambda e: e.fused_rollout(pstate, pacts, strict=True),
             lambda: PK.plain_pmsm_rollout(fleet, pacts, *PK._start(pstate), tau=fleet.tau, batch_major=True)[0],
             lambda out: tuple(getattr(out[1].physical_state, f) for f in ("i_d", "i_q", "torque", "epsilon",
                                                                          "u_d_buffer", "u_q_buffer")),
             PK.KERNEL, "pmsm_step", *pmsm_bound(fleet, fleet._solver, B, Tp, 0), PMSM_SOURCE, PMSM_REPLACES, Tp)

    # kernel 2: the PD tracking law over the pendulum
    cenv = ex.Pendulum(batch_size=B, control_state=["theta"], device=DEVICE)
    _, cstate = cenv.vmap_reset(rng=gen)
    cstate.reference.theta = torch.linspace(-1.5, 1.5, B, device=DEVICE)
    pd = ex.AffinePolicy(PD_GAINS)
    cy0 = tuple(getattr(cstate.physical_state, f) for f in cenv._ode_state_fields)
    ckw = dict(tau=cenv.tau, solver=cenv._solver, props=cenv.env_properties,
               ref_leaves=(cenv.env_properties.physical_normalizations.theta.normalize(cstate.reference.theta),))
    (cl_bound_ms, cl_bound_by), _ = cl_bound(cenv, pd.kernel_spec(torch.float32, DEVICE), B, T, 0, 0, 1)
    run_case("closed_loop_pd_split4", cenv, ShardedEnv(cenv, mesh), lambda e: e.fused_closed_loop(cstate, pd, T),
             lambda e: e.fused_closed_loop(cstate, pd, T),
             lambda: cl_flat(CL.plain_closed_loop(cenv, cy0, pd, T, **ckw))[:2],
             lambda out: tuple(getattr(out[1].physical_state, f) for f in cenv._ode_state_fields), CL.CL_KERNEL,
             "closed_loop", cl_bound_ms, cl_bound_by, CL_SOURCE, CL_REPLACES, T)

    # kernel 4: the PI current law over a BRUSA fleet whose DC link differs per drive
    Tc = T_SHARD_PCL
    u_dc = 350.0 + 100.0 * torch.rand(B, generator=gen, device=DEVICE)
    penv = pmsm_env(ex, B, static={"u_dc": u_dc}, control_state=["i_d", "i_q"], tau=1e-4)
    pcstate, state0, omega, refs = pcl_inputs(penv, gen)
    pi_law = ex.AffinePolicy(PCL_P, Ki=PCL_KI)
    c0 = tuple(torch.zeros(B, device=DEVICE) for _ in range(2))
    pkw = dict(tau=penv.tau, solver=penv._solver, props=penv.env_properties, ref_leaves=refs, policy_carry=c0)
    (pcl_bound_ms, pcl_bound_by), _ = pmsm_cl_bound(penv, pi_law.kernel_spec(torch.float32, DEVICE), B, Tc, 0, 2, 2)
    run_case("pmsm_closed_loop_pi_split4", penv, ShardedEnv(penv, mesh),
             lambda e: e.fused_closed_loop(pcstate, pi_law, Tc, policy_carry=c0),
             lambda e: e.fused_closed_loop(pcstate, pi_law, Tc, policy_carry=c0),
             lambda: cl_flat(PCL.plain_pmsm_closed_loop(penv, state0, omega, pi_law, Tc, **pkw))[:2],
             lambda out: (out[1].physical_state.i_d, out[1].physical_state.i_q), PCL.PMSM_CL_KERNEL,
             "pmsm_closed_loop", pcl_bound_ms, pcl_bound_by, PCL_SOURCE, PCL_REPLACES, Tc)
    return entries


def phase_wrappers(ex):
    """The wrappers on the card, float32, B = 65,536: ``GymWrapper`` on the
    tracking Pendulum with references on (hold steps 10..1,000) over 1,000
    steps, and the vector step with NEXT_STEP autoreset
    (``utils/episodes.py::_autoreset_step``, ``max_episode_steps = 200``) over
    1,000 steps, each reading its flags on the host every step as
    ``GymnasiumVectorEnv.step`` does; ms per step, the renewals and resets
    counted and checked.  ``GymnasiumVectorEnv`` and ``MujucoWrapper`` (B =
    256, 20 steps, state on the card) run where gymnasium and mujoco
    import; where they do not, a line names what was not driven."""
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.utils import episodes

    card = card_line()
    B, n_steps = B_MAIN, 1000

    def log_w(msg):
        log(f"[wrappers] {msg} ({card})")

    env = ex.Pendulum(batch_size=B, tau=1e-4, control_state=["theta"], device=DEVICE)
    gw = ex.GymWrapper(env=env, control_state=["theta"])
    gw.reset(rng_env=R.split(R.PRNGKey(SEED, DEVICE), B), rng_ref=R.PRNGKey(SEED + 1, DEVICE))
    action = torch.zeros(B, 1, device=DEVICE)
    renewals = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        before = gw.reference_hold_steps
        obs, reward, term, trunc = gw.step(action)
        renewals += int((before[:, 0] == 0).sum())  # a host read per step, as a caller's loop makes
    torch.cuda.synchronize()
    gw_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    if tuple(obs.shape) != (B, 3) or tuple(reward.shape) != (B, 1) or not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"GymWrapper: unexpected step result {tuple(obs.shape)}, {tuple(reward.shape)}")
    hold = gw.reference_hold_steps
    if renewals < B or int(hold.min()) < -1 or int(hold.max()) >= 1000:
        raise AssertionError(f"GymWrapper: {renewals} renewals, hold steps in [{int(hold.min())}, {int(hold.max())}]")
    log_w(f"GymWrapper Pendulum B={B}, references on: {gw_ms!r} ms per step over {n_steps} steps, "
          f"{renewals} reference renewals, {B / gw_ms * 1e3:.4e} env-steps/s")

    limit = 200
    _, state = episodes.reset_with_references(env, R.PRNGKey(SEED + 2, DEVICE))
    autoreset = torch.zeros(B, dtype=torch.bool, device=DEVICE)
    elapsed = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    keys = R.split(R.PRNGKey(SEED + 3, DEVICE), n_steps)
    any_reset, reset_steps = False, 0
    reset_reward = torch.zeros((), device=DEVICE)  # the largest |reward| of an instance on its reset step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n_steps):
        reset_steps += any_reset
        was = autoreset
        obs, reward, term, trunc, state, autoreset, elapsed = episodes._autoreset_step(
            env, state, autoreset, any_reset, elapsed, action, keys[t], limit)
        reset_reward = torch.maximum(reset_reward, torch.where(was, reward, 0.0).abs().max())
        any_reset = bool(autoreset.any())  # the host copy GymnasiumVectorEnv.step reads
    torch.cuda.synchronize()
    vec_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    if (reset_steps < n_steps // limit - 1 or int(elapsed.max()) > limit or float(reset_reward) != 0.0
            or not bool(torch.isfinite(obs).all())):
        raise AssertionError(f"autoreset: {reset_steps} reset steps, elapsed up to {int(elapsed.max())}, "
                             f"reward on a reset step {float(reset_reward)!r}")
    log_w(f"_autoreset_step Pendulum B={B}, max_episode_steps={limit}: {vec_ms!r} ms per step over {n_steps} "
          f"steps, {reset_steps} steps with a reset branch, {B / vec_ms * 1e3:.4e} env-steps/s")

    b, n_small = 256, 20
    try:
        import gymnasium  # noqa: F401
    except ImportError:
        log_w("GymnasiumVectorEnv not driven: gymnasium does not import on this machine")
    else:
        venv = ex.GymnasiumVectorEnv(ex.Pendulum(batch_size=b, control_state=["theta"], device=DEVICE),
                                     seed=SEED, max_episode_steps=8)
        venv.reset(seed=SEED)
        for _ in range(n_small):
            o, r, te, tr, _ = venv.step(np.zeros((b, 1), np.float32))
        if o.shape != (b, 3) or not np.isfinite(o).all():
            raise AssertionError("GymnasiumVectorEnv: unexpected observations")
        log_w(f"GymnasiumVectorEnv B={b}: {n_small} steps, state on {venv._state.physical_state.theta.device}")
    try:
        import mujoco
    except ImportError:
        log_w("MujucoWrapper not driven: mujoco does not import on this machine")
    else:
        mw = mujoco_pendulum(ex, mujoco, b)
        obs, st = mw.vmap_reset(R.split(R.PRNGKey(SEED, DEVICE), b))
        for _ in range(n_small):
            obs, st = mw.vmap_step(st, 0.5 * torch.ones(b, 1, device=DEVICE))
        if st.qpos.device.type != torch.device(DEVICE).type or not bool(torch.isfinite(obs).all()):
            raise AssertionError("MujucoWrapper: state left the card or went non-finite")
        log_w(f"MujucoWrapper B={b}: {n_small} steps, state on {st.qpos.device}")


MUJOCO_PENDULUM_XML = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.01"/>
  <worldbody>
    <body name="pole" pos="0 0 1">
      <joint name="hinge" type="hinge" axis="0 1 0" limited="true" range="-1.5 1.5"/>
      <geom type="capsule" size="0.04" fromto="0 0 0 0 0 0.5" mass="1"/>
    </body>
  </worldbody>
  <actuator>
    <motor name="torque" joint="hinge" ctrllimited="true" ctrlrange="-2 2"/>
  </actuator>
</mujoco>
"""


def mujoco_pendulum(ex, mujoco, batch):
    """The MuJoCo wrapper over the tests' hinge pendulum, state on the card."""
    from exciting_environments_torch.wrappers.mujoco import MujucoWrapper, dict_to_pytree_dataclass

    model = mujoco.MjModel.from_xml_string(MUJOCO_PENDULUM_XML)
    base = MujucoWrapper.__new__(MujucoWrapper)
    phys = base.generate_physical_normalization_dataclasses.__get__(base)(model)
    qvel, _ = dict_to_pytree_dataclass("qvel", {"hinge_angular_velocity": ex.MinMaxNormalization(-10.0, 10.0)})
    return MujucoWrapper(model, physical_normalizations=MujucoWrapper.PhysicalNormalizations(qpos=phys.qpos,
                                                                                              qvel=qvel),
                         batch_size=batch, device=DEVICE)


# ---------------------------------------------------------------------------
# the fleet loop (utils/fleet.py) and the dataset path (io/)
# ---------------------------------------------------------------------------

FLEET_CHUNKS, FLEET_T = 16, 256  # T = 4,096 in all, as row 1a
FLEET_CKPT_EVERY = 8
FLEET_PMSM_CHUNKS, FLEET_PMSM_T = 4, 64  # T = 256, as row 3a
FLEET_CL_CHUNKS, FLEET_CL_T = 4, 1024  # T = 4,096, as row 2a
FLEET_PCL_CHUNKS, FLEET_PCL_T = 4, 512  # T = 2,048, as row 4b
FLEET_SPLIT_CHUNKS = 2


FLEET_HEAD_ROWS = 64  # rows of a record's actions a DataLoader worker ships (its /dev/shm may be small)


def fleet_record_head(name, tensors):
    """A fleet record with its actions cut to their first rows."""
    return {"final_obs": tensors["final_obs"], "actions": tensors["actions"][:FLEET_HEAD_ROWS].clone()}


def chained_ms(fn):
    """Device time of ``fn()`` (a chain of launches) between two CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def phase_fleet(ex, K, PK, CL, PCL):
    """The fleet loop and the dataset path on the card, float32, B = 65,536
    (``utils/fleet.py``, ``io/``).  ``FleetRunner.run`` on the Pendulum, 16
    chunks of 256 steps (kernel 1, row 1o) into a native ``ShardWriter``
    with the actions (~1.08 GB) and a checkpoint every 8 chunks; on
    saturated BRUSA, 4 chunks of 64 (kernel 3, row 3i); ``run_policy`` with
    the PD law on the tracking Pendulum, 4 chunks of 1,024 (kernel 2, row
    2k), and with the stateful PI law and its carry on BRUSA, 4 chunks of
    512 (kernel 4, row 4g); the Pendulum runner over ``ShardedEnv(env,
    make_batch_mesh(["cuda:0"] * 4))``, 2 chunks.  Gates: the path names, one
    launch per chunk (four when split; the counts set to 0 just before each
    run, read just after), every final state 0.0 from the same chunks driven
    directly through the entry points and from the plain versions, the
    summary's step count, the writer's native library, every shard record
    equal to its chunk's ``final_obs`` and actions, a resume from the chunk-8
    checkpoint and a retried chunk (a ``RuntimeError`` injected into chunk 3,
    ``max_retries=1``) bit for bit with the straight run, and a plain
    callable on the CUDA Pendulum raising before a launch.  Then the data
    loop: ``DeviceLoader([shard], prefetch=2)`` replays every loaded action
    chunk through kernel 1 from the start state and meets every recorded
    ``final_obs`` at 0.0 (against the same loop over a synchronous read and
    copy: the host->device rate and the share of the consumer's kernel time
    the prefetch hid), the worker gone after an early ``break``, two records
    through ``torch.utils.data.DataLoader(TorchShardDataset(shard),
    num_workers=2)``, and the shard CLI's lines.  Returns rows 1o, 2k, 3i and
    4g."""
    import os
    import tempfile
    import threading

    from torch.utils.data import DataLoader

    from exciting_environments_torch.io import DeviceLoader, ShardIndex, ShardWriter, TorchShardDataset
    from exciting_environments_torch.parallel import ShardedEnv, make_batch_mesh
    from exciting_environments_torch.utils.fleet import FleetRunner

    card = card_line()
    B = B_MAIN
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 70)
    entries = []

    def log_f(msg):
        log(f"[fleet] {msg} ({card})")

    def require(ok, what):
        if not ok:
            raise AssertionError(f"phase_fleet: {what}")

    def same_stats(a, b):
        return all(torch.equal(getattr(a.obs_stats, f), getattr(b.obs_stats, f))
                   for f in ("count", "mean", "m2", "min", "max"))

    def traced(runner):
        """Wrap ``runner``'s rollout call: per chunk, the host time of the call
        and the device time between CUDA events around it."""
        inner, spans = runner._rollout, []

        def rollout(state, actions):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            e0.record()
            out = inner(state, actions)
            e1.record()
            spans.append((e0, e1, (time.perf_counter() - h0) * 1e3))
            return out

        runner._rollout = rollout
        return spans

    def span_medians(spans):
        torch.cuda.synchronize()
        return (statistics.median(h for _, _, h in spans), statistics.median(e0.elapsed_time(e1) for e0, e1, _ in spans))

    def batch_major(env, n_steps, lim=0.9):
        u = torch.rand((env.batch_size, n_steps, env.action_dim), generator=gen, device=DEVICE, dtype=torch.float64)
        return ((u * 2 - 1) * lim).to(env.dtype)

    def report(row, name, runner, n_chunks, n_steps, launches, err, ms, plain_ms, bound_ms, bound_by, source,
               replaces, direct_ms):
        summ = runner.summary()
        require(summ["chunks"] == n_chunks and summ["env_steps"] == B * n_chunks * n_steps,
                f"{name}: summary {summ['chunks']} chunks, {summ['env_steps']} env-steps")
        bare = B * n_chunks * n_steps / direct_ms * 1e3
        log_f(f"row {row} {name} ({runner.rollout_path if row in ('1o', '3i') else runner.closed_loop_path}): "
              f"{n_chunks} chunks x {n_steps} steps, {launches} launches; env_steps_per_sec "
              f"{summ['env_steps_per_sec']:.4e} (summary, mean chunk {summ['mean_chunk_seconds'] * 1e3!r} ms) vs "
              f"{bare:.4e} for the {n_chunks} bare chained calls ({direct_ms!r} ms, events); one chunk's entry point "
              f"{ms!r} ms, bound {bound_ms!r} ms ({bound_by}), plain {plain_ms!r} ms (one chunk); vs direct calls "
              f"and plain {err!r}")
        entries.append(entry(name, launches, err, ms, plain_ms, bound_ms, bound_by, source, replaces))

    # -- row 1o: the Pendulum's open loop through kernel 1 into the shard --------------------------
    n, T = FLEET_CHUNKS, FLEET_T
    env = ex.Pendulum(batch_size=B, tau=1e-4, device=DEVICE)
    _, s0 = env.vmap_reset(rng=gen)
    slabs = [batch_major(env, T) for _ in range(n)]
    fields = env._ode_state_fields

    def direct(start, ks):
        state, outs = start, []
        for k in ks:
            obs, state = env.fused_rollout(state, slabs[k], strict=True)
            outs.append(obs)
        return outs, state

    direct(s0, range(2))  # warm: the timed chain below starts from loaded libraries and caches
    direct_ms, (direct_obs, direct_final) = chained_ms(lambda: direct(s0, range(n)))
    with tempfile.TemporaryDirectory() as tmp:
        shard = os.path.join(tmp, "fleet.extpu")
        writer = ShardWriter(shard)
        require(writer.native, "the shard writer did not build its native library (the host has g++)")
        runner = FleetRunner(env, writer=writer, write_actions=True, checkpoint_dir=tmp,
                             checkpoint_every=FLEET_CKPT_EVERY)
        require(runner.rollout_path == "fused", f"the Pendulum runner took {runner.rollout_path!r}")
        sink_spans = traced(runner)
        torch.cuda.synchronize()
        K.KERNEL.reset_counts()
        t0 = time.perf_counter()
        final = runner.run(s0, lambda k: slabs[k], n, T)
        launches = K.KERNEL.launches["step"]
        written = writer.close()
        sink_s = time.perf_counter() - t0
        require(launches == n, f"the Pendulum runner made {launches} stepper launches for {n} chunks")
        gap = tree_gap(final, direct_final)
        y0 = tuple(getattr(s0.physical_state, f) for f in fields)
        acts_tm = torch.cat([a.transpose(0, 1) for a in slabs])
        t0 = time.perf_counter()
        plain = K.plain_rollout(env, y0, acts_tm, tau=env.tau)[0]
        torch.cuda.synchronize()
        plain_full_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs(tuple(getattr(final.physical_state, f) for f in fields), plain)
        del acts_tm, plain
        require(gap == 0.0 and err == 0.0, f"the Pendulum runner vs direct calls {gap!r}, vs plain {err!r}")
        t0 = time.perf_counter()
        plain0 = K.plain_rollout(env, y0, slabs[0].transpose(0, 1), tau=env.tau)[0]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        first = env.fused_rollout(s0, slabs[0], strict=True)[1]
        err = max(err, max_abs(tuple(getattr(first.physical_state, f) for f in fields), plain0))
        ms = time_ms(lambda: env.fused_rollout(s0, slabs[0], strict=True))

        # the same run without the sink and checkpoints
        bare_runner = FleetRunner(env)
        bare_spans = traced(bare_runner)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bare_final = bare_runner.run(s0, lambda k: slabs[k], n, T)
        torch.cuda.synchronize()
        nosink_s = time.perf_counter() - t0
        require(tree_gap(bare_final, final) == 0.0 and same_stats(bare_runner, runner),
                "the run without the sink differs from the run with it")

        def chunk_ms(r):  # the runner's own per-chunk spans (launch to the gate's sync), min/median/max
            spans = sorted(x * 1e3 for x in list(r.time_window)[-n:])
            return f"{spans[0]:.3f}/{statistics.median(spans):.3f}/{spans[-1]:.3f}"

        log_f(f"sink: the 16-chunk run with the native writer (actions and final_obs, {written} bytes, checkpoints "
              f"every {FLEET_CKPT_EVERY} chunks) {sink_s * 1e3!r} ms against {nosink_s * 1e3!r} ms without "
              f"({(sink_s - nosink_s) / n * 1e3:.3f} ms per chunk; {written / sink_s / 1e9:.3f} GB/s written over "
              f"the whole run); chunk spans min/median/max {chunk_ms(runner)} ms with the sink, "
              f"{chunk_ms(bare_runner)} ms without (env_steps_per_sec {runner.summary()['env_steps_per_sec']:.4e} "
              f"and {bare_runner.summary()['env_steps_per_sec']:.4e}); median rollout call host/device ms "
              f"{'/'.join(f'{x:.3f}' for x in span_medians(sink_spans))} with the sink, "
              f"{'/'.join(f'{x:.3f}' for x in span_medians(bare_spans))} without; plain over all {n * T} steps "
              f"{plain_full_ms!r} ms")

        # every record read back through ShardIndex
        with ShardIndex(shard) as idx:
            require(idx.names == [f"chunk_{i:06d}" for i in range(1, n + 1)], f"shard records {idx.names}")
            for i in range(n):
                _, arrays = idx.entry(i)
                require(np.array_equal(arrays["['final_obs']"], direct_obs[i].cpu().numpy())
                        and np.array_equal(arrays["['actions']"], slabs[i].cpu().numpy()),
                        f"shard record {i} differs from its chunk")

        # resume from the chunk-8 checkpoint
        require(FleetRunner.latest_checkpoint(tmp) == os.path.join(tmp, f"fleet_{n:06d}.npz"),
                "the newest checkpoint is not the last chunk's")
        resumed_runner = FleetRunner(env, checkpoint_dir=tmp)
        resumed, done = resumed_runner.resume(s0, path=os.path.join(tmp, f"fleet_{FLEET_CKPT_EVERY:06d}.npz"))
        require(done == FLEET_CKPT_EVERY, f"resume reports {done} chunks done")
        resumed_final = resumed_runner.run(resumed, lambda k: slabs[k + done], n - done, T)
        require(tree_gap(resumed_final, final) == 0.0 and same_stats(resumed_runner, runner)
                and resumed_runner.env_steps == B * n * T, "the resumed run differs from the straight run")

        # a transient failure in chunk 3, retried from the snapshot
        flaky = FleetRunner(env)
        rollout, calls = flaky._rollout, []

        def failing(state, actions):
            calls.append(1)
            if len(calls) == 4:
                raise RuntimeError("injected failure in chunk 3")
            return rollout(state, actions)

        flaky._rollout = failing
        retried = flaky.run(s0, lambda k: slabs[k], n, T, max_retries=1)
        require(len(calls) == n + 1 and tree_gap(retried, final) == 0.0 and same_stats(flaky, runner)
                and flaky.summary()["env_steps"] == B * n * T, "the retried run differs from the clean run")
        log_f(f"resume from chunk {done} and a retried chunk 3: 0.0 from the straight run (state and statistics)")
        report("1o", "stepper_step_fleet", runner, n, T, launches, err, ms, plain_ms,
               *bound(env, env._solver, B, T, T, 0, False), SOURCE, REPLACES, direct_ms)

        # -- the data loop: the shard back onto the card, replayed through kernel 1 ------------------
        def replay(batches, check_actions):
            state, worst, nbytes = s0, 0.0, 0
            for i, (name, batch) in enumerate(batches):
                acts, rec = batch["['actions']"], batch["['final_obs']"]
                require(acts.device.type == rec.device.type == torch.device(DEVICE).type, f"{name} is not on the card")
                if check_actions:
                    require(torch.equal(acts, slabs[i]) and torch.equal(rec, direct_obs[i]),
                            f"{name}: a loaded leaf differs from the shard's bytes")
                obs, state = env.fused_rollout(state, acts, strict=True)
                worst = max(worst, leaf_deviation(obs, rec))
                nbytes += acts.numel() * acts.element_size() + rec.numel() * rec.element_size()
            torch.cuda.synchronize()
            return worst, nbytes, state

        def synchronous(path):
            with ShardIndex(path) as idx:
                for name, arrays in idx:
                    yield name, {k: torch.from_numpy(np.array(v)).to(DEVICE) for k, v in arrays.items()}

        replay(DeviceLoader([shard], prefetch=2, device=DEVICE), False)  # warm the pinned-memory cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        worst, nbytes, replayed = replay(DeviceLoader([shard], prefetch=2, device=DEVICE), False)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        worst_sync, _, _ = replay(synchronous(shard), False)
        sync_s = time.perf_counter() - t0
        replay(DeviceLoader([shard], prefetch=2, device=DEVICE), True)
        require(worst == 0.0 and worst_sync == 0.0 and tree_gap(replayed, final) == 0.0,
                f"the replay from the loaded chunks misses the recorded final_obs ({worst!r}, {worst_sync!r})")
        hidden = min(direct_ms, max(0.0, (sync_s - load_s) * 1e3)) / direct_ms
        log_f(f"DeviceLoader(prefetch=2): {n} records, {nbytes} bytes host->device and replayed through kernel 1 in "
              f"{load_s * 1e3!r} ms ({nbytes / load_s / 1e9:.3f} GB/s) against {sync_s * 1e3!r} ms "
              f"({nbytes / sync_s / 1e9:.3f} GB/s) for a synchronous read and copy; the consumer's kernels "
              f"{direct_ms!r} ms, {hidden:.1%} of it hidden by the prefetch; every final_obs met at 0.0")
        before = {t.ident for t in threading.enumerate()}
        for _ in DeviceLoader([shard], prefetch=2, device=DEVICE):
            break
        leaked = [t.name for t in threading.enumerate() if t.ident not in before]
        require(not leaked, f"the loader's worker outlived an early break: {leaked}")

        ds = TorchShardDataset(shard, transform=fleet_record_head)
        it = iter(DataLoader(ds, batch_size=None, num_workers=2, multiprocessing_context="spawn"))
        got = [next(it), next(it)]
        del it
        ds.close()
        require(all(torch.equal(g["final_obs"], direct_obs[i].cpu())
                    and torch.equal(g["actions"], slabs[i][:FLEET_HEAD_ROWS].cpu()) for i, g in enumerate(got)),
                "DataLoader(TorchShardDataset) records differ from the chunks")
        cli = subprocess.run([sys.executable, "-m", "exciting_environments_torch.io", shard], cwd=ROOT,
                             capture_output=True, text=True, check=True, timeout=120).stdout.splitlines()
        require(len(cli) == n + 2 and cli[0].endswith(f": {n} records"), f"the shard CLI printed {cli[:3]}")
        log_f(f"DataLoader(TorchShardDataset, num_workers=2, spawn): 2 records equal to the chunks; the worker gone after "
              f"an early break; python -m exciting_environments_torch.io:")
        for line in [cli[0].replace(shard, "<shard>"), *cli[1:3], "  ...", cli[-1]]:
            log(f"[fleet cli] {line}")
    del slabs, direct_obs

    # -- the split: the Pendulum runner over four shards of the card -------------------------------
    slabs = [batch_major(env, T) for _ in range(FLEET_SPLIT_CHUNKS)]
    split = FleetRunner(ShardedEnv(env, make_batch_mesh(SHARD_DEVICES)))
    require(split.rollout_path == "sharded_fused", f"the split runner took {split.rollout_path!r}")
    torch.cuda.synchronize()
    K.KERNEL.reset_counts()
    split_final = split.run(s0, lambda k: slabs[k], FLEET_SPLIT_CHUNKS, T)
    split_launches = K.KERNEL.launches["step"]
    whole = FleetRunner(env)
    whole_final = whole.run(s0, lambda k: slabs[k], FLEET_SPLIT_CHUNKS, T)
    require(split_launches == 4 * FLEET_SPLIT_CHUNKS and tree_gap(split_final, whole_final) == 0.0
            and same_stats(split, whole), f"the split runner: {split_launches} launches, "
                                          f"{tree_gap(split_final, whole_final)!r} from the unsplit runner")
    log_f(f"ShardedEnv over {SHARD_DEVICES}: {FLEET_SPLIT_CHUNKS} chunks, {split_launches} launches (4 per chunk), "
          f"0.0 from the unsplit runner; env_steps_per_sec {split.summary()['env_steps_per_sec']:.4e} split, "
          f"{whole.summary()['env_steps_per_sec']:.4e} unsplit")
    del slabs

    # -- row 3i: saturated BRUSA through kernel 3 ----------------------------------------------------
    n, T = FLEET_PMSM_CHUNKS, FLEET_PMSM_T
    drive = pmsm_env(ex, B, tau=1e-4)
    _, d0 = drive.vmap_reset(rng=gen)
    vslabs = [batch_major(drive, T) for _ in range(n)]
    pfields = ("i_d", "i_q", "torque", "epsilon", "u_d_buffer", "u_q_buffer")

    def pdirect():
        state = d0
        for k in range(n):
            _, state = drive.fused_rollout(state, vslabs[k], strict=True)
        return state

    pdirect()  # warm
    pdirect_ms, pdirect_final = chained_ms(pdirect)
    prunner = FleetRunner(drive)
    require(prunner.rollout_path == "pmsm_fused", f"the BRUSA runner took {prunner.rollout_path!r}")
    torch.cuda.synchronize()
    PK.KERNEL.reset_counts()
    pfinal = prunner.run(d0, lambda k: vslabs[k], n, T)
    plaunches = PK.KERNEL.launches["pmsm_step"]
    require(plaunches == n and tree_gap(pfinal, pdirect_final) == 0.0,
            f"the BRUSA runner: {plaunches} launches, {tree_gap(pfinal, pdirect_final)!r} from direct calls")
    t0 = time.perf_counter()
    pplain = PK.plain_pmsm_rollout(drive, vslabs[0], *PK._start(d0), tau=drive.tau, batch_major=True)[0]
    torch.cuda.synchronize()
    pplain_ms = (time.perf_counter() - t0) * 1e3
    pfirst = drive.fused_rollout(d0, vslabs[0], strict=True)[1]
    perr = max_abs(tuple(getattr(pfirst.physical_state, f) for f in pfields), pplain)
    require(perr == 0.0, f"BRUSA's first chunk vs plain {perr!r}")
    pms = time_ms(lambda: drive.fused_rollout(d0, vslabs[0], strict=True))
    report("3i", "pmsm_step_fleet", prunner, n, T, plaunches, perr, pms, pplain_ms,
           *pmsm_bound(drive, drive._solver, B, T, 0), PMSM_SOURCE, PMSM_REPLACES, pdirect_ms)
    del vslabs

    # -- row 2k: the PD law on the tracking Pendulum through kernel 2 -------------------------------
    n, T = FLEET_CL_CHUNKS, FLEET_CL_T
    cenv = ex.Pendulum(batch_size=B, control_state=["theta"], device=DEVICE)
    _, c0 = cenv.vmap_reset(rng=gen)
    c0.reference.theta = torch.linspace(-1.5, 1.5, B, device=DEVICE)
    pd = ex.AffinePolicy(PD_GAINS)

    def cdirect():
        state = c0
        for _ in range(n):
            _, state = cenv.fused_closed_loop(state, pd, T)
        return state

    cdirect()  # warm
    cdirect_ms, cdirect_final = chained_ms(cdirect)
    crunner = FleetRunner(cenv)
    torch.cuda.synchronize()
    CL.CL_KERNEL.reset_counts()
    cfinal = crunner.run_policy(c0, pd, n, T)
    claunches = CL.CL_KERNEL.launches["closed_loop"]
    require(crunner.closed_loop_path == "closed_loop_fused" and claunches == n
            and tree_gap(cfinal, cdirect_final) == 0.0,
            f"the PD runner: {crunner.closed_loop_path!r}, {claunches} launches, "
            f"{tree_gap(cfinal, cdirect_final)!r} from direct calls")
    CL.CL_KERNEL.reset_counts()
    try:
        FleetRunner(cenv).run_policy(c0, lambda obs, t: (-0.5 * obs[0],), 1, T)
    except ValueError:
        pass
    else:
        raise AssertionError("phase_fleet: a plain callable on the CUDA Pendulum did not raise")
    require(CL.CL_KERNEL.launches["closed_loop"] == 0, "the plain callable reached a launch")
    cy0 = tuple(getattr(c0.physical_state, f) for f in cenv._ode_state_fields)
    ckw = dict(tau=cenv.tau, solver=cenv._solver, props=cenv.env_properties,
               ref_leaves=(cenv.env_properties.physical_normalizations.theta.normalize(c0.reference.theta),))
    t0 = time.perf_counter()
    cplain = cl_flat(CL.plain_closed_loop(cenv, cy0, pd, T, **ckw))[:2]
    torch.cuda.synchronize()
    cplain_ms = (time.perf_counter() - t0) * 1e3
    cfirst = cenv.fused_closed_loop(c0, pd, T)[1]
    cerr = max_abs(tuple(getattr(cfirst.physical_state, f) for f in cenv._ode_state_fields), cplain)
    require(cerr == 0.0, f"the PD law's first chunk vs plain {cerr!r}")
    cms = time_ms(lambda: cenv.fused_closed_loop(c0, pd, T))
    (cl_bound_ms, cl_bound_by), _ = cl_bound(cenv, pd.kernel_spec(torch.float32, DEVICE), B, T, 0, 0, 1)
    report("2k", "closed_loop_pd_fleet", crunner, n, T, claunches, cerr, cms, cplain_ms, cl_bound_ms, cl_bound_by,
           CL_SOURCE, CL_REPLACES, cdirect_ms)

    # -- row 4g: the stateful PI law and its carry on BRUSA through kernel 4 -------------------------
    n, T = FLEET_PCL_CHUNKS, FLEET_PCL_T
    penv = pmsm_env(ex, B, control_state=["i_d", "i_q"], tau=1e-4)
    q0, qstate0, omega, refs = pcl_inputs(penv, gen)
    pi_law = ex.AffinePolicy(PCL_P, Ki=PCL_KI)
    carry0 = tuple(torch.zeros(B, device=DEVICE) for _ in range(2))

    def qdirect():
        state, carry = q0, carry0
        for _ in range(n):
            _, state, carry = penv.fused_closed_loop(state, pi_law, T, policy_carry=carry)
        return state, carry

    qdirect()  # warm
    qdirect_ms, qdirect_final = chained_ms(qdirect)
    qrunner = FleetRunner(penv)
    torch.cuda.synchronize()
    PCL.PMSM_CL_KERNEL.reset_counts()
    qfinal = qrunner.run_policy(q0, pi_law, n, T, policy_carry=carry0)
    qlaunches = PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"]
    require(qrunner.closed_loop_path == "pmsm_closed_loop_fused" and qlaunches == n
            and tree_gap(qfinal, qdirect_final) == 0.0,
            f"the PI runner: {qrunner.closed_loop_path!r}, {qlaunches} launches, "
            f"{tree_gap(qfinal, qdirect_final)!r} from direct calls")
    pkw = dict(tau=penv.tau, solver=penv._solver, props=penv.env_properties, ref_leaves=refs, policy_carry=carry0)
    t0 = time.perf_counter()
    qplain = cl_flat(PCL.plain_pmsm_closed_loop(penv, qstate0, omega, pi_law, T, **pkw))[:2]
    torch.cuda.synchronize()
    qplain_ms = (time.perf_counter() - t0) * 1e3
    qfirst = penv.fused_closed_loop(q0, pi_law, T, policy_carry=carry0)[1]
    qerr = max_abs((qfirst.physical_state.i_d, qfirst.physical_state.i_q), qplain)
    require(qerr == 0.0, f"the PI law's first chunk vs plain {qerr!r}")
    qms = time_ms(lambda: penv.fused_closed_loop(q0, pi_law, T, policy_carry=carry0))
    (pcl_bound_ms, pcl_bound_by), _ = pmsm_cl_bound(penv, pi_law.kernel_spec(torch.float32, DEVICE), B, T, 0, 2, 2)
    report("4g", "pmsm_closed_loop_pi_fleet", qrunner, n, T, qlaunches, qerr, qms, qplain_ms, pcl_bound_ms,
           pcl_bound_by, PCL_SOURCE, PCL_REPLACES, qdirect_ms)
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--sass"]:
        return sass_report(sys.argv[2:])
    csrc = ROOT / "exciting_environments_torch" / "csrc"
    if not all((csrc / f"{name}.cu").is_file() for name in ("stepper", "pmsm_stepper", "closed_loop",
                                                           "pmsm_closed_loop", "pendulum_fast", "pmsm_fast")):
        print("chip_smoke: run it from a checkout of the repository (package not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import exciting_environments_torch as ex
    from exciting_environments_torch.ops import pmsm_fast as PF
    from exciting_environments_torch.ops.kernels import closed_loop as CL
    from exciting_environments_torch.ops.kernels import pendulum_fast as PFK
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
    from exciting_environments_torch.ops.kernels import pmsm_fast_kernel as PMK
    from exciting_environments_torch.ops.kernels import pmsm_stepper as PK
    from exciting_environments_torch.ops.kernels import stepper as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()

    def phase(fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        log(f"[time] {fn.__name__} {time.perf_counter() - start:.1f}")
        return out

    phase(phase_build, K)
    phase(phase_kernel_vs_plain, ex, K)
    phase(phase_golden, ex, K)
    kernels = phase(phase_main, ex, K)
    phase(phase_sector, PK)
    phase(phase_pmsm_kernel_vs_plain, ex, PK)
    phase(phase_pmsm_golden, ex, PK)
    kernels += phase(phase_pmsm_main, ex, PK)
    phase(phase_cl_kernel_vs_plain, ex, CL)
    kernels += phase(phase_cl_main, ex, CL)
    phase(phase_trig)
    phase(phase_pcl_kernel_vs_plain, ex, PCL)
    kernels += phase(phase_pcl_main, ex, PCL)
    kernels += phase(phase_fast_flag, ex, K, CL)
    kernels += phase(phase_pendulum_fast, ex, PFK)
    kernels += phase(phase_pmsm_fast, ex, PF, PMK)
    phase(phase_env_kernel_vs_plain, ex, K, CL)
    phase(phase_env_golden, ex, K)
    kernels += phase(phase_env_main, ex, K, CL)
    kernels += phase(phase_foc, ex, K, CL)
    phase(phase_draws, ex)
    kernels += phase(phase_noise_pendulum, ex, K)
    kernels += phase(phase_noise_pmsm, ex, PK)
    phase(phase_noise_closed_loops, ex, CL, PCL)
    grads = phase(phase_grad, ex, K, CL, PK, PCL)
    grads += phase(phase_train, ex, CL, PCL)
    kernels += phase(phase_adjoint, ex, PCL)
    kernels += phase(phase_rl, ex, CL, PCL)
    kernels += phase(phase_collect, ex, K, PK)
    kernels += phase(phase_plan, ex, K, PK)
    kernels += phase(phase_ident, ex, K, PK)
    kernels += phase(phase_shard, ex, K, PK, CL, PCL)
    phase(phase_wrappers, ex)
    kernels += phase(phase_fleet, ex, K, PK, CL, PCL)
    if "jax" in sys.modules or any(m.startswith("exciting_environments_tpu") for m in sys.modules):
        raise AssertionError("the port pulled in JAX or the JAX package")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"grads": grads}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
