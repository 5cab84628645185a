#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build the six kernel libraries (``exciting_environments_torch/csrc/
   stepper.cu``, ``pmsm_stepper.cu``, ``closed_loop.cu``,
   ``pmsm_closed_loop.cu``, ``pendulum_fast.cu`` and ``pmsm_fast.cu``), one
   nvcc each, started together, and report the build time and each compiler
   resource report;
2. hold the stepper kernel against its plain PyTorch version on the card at
   B = 65,536, T = 64, float32, in every mode the port uses;
3. replay the pendulum golden fixture (``tests/envs/pendulum/data``) through
   the kernel in float64 and check it with the fixture test's own allclose;
4. drive the pendulum main path: ``Pendulum(batch_size=65536, tau=1e-4)`` and
   ``env.fused_rollout`` over T = 4,096 steps in float32, in both action
   layouts, plus ``env.fused_sim_ahead`` (RK4) at the same size; show through
   the launch counts that it ran the kernel, time it with CUDA events and
   compare it with the plain version on the same inputs;
5. hold the PMSM kernel against its plain version at B = 65,536, T = 64,
   float32 (and one float64 case), tolerance 0.0, over the motor variants,
   solvers, deadtimes, per-batch parameters, saves, sim-ahead and a ragged B;
6. replay the PMSM golden fixture (``tests/envs/pmsm/data``) through the
   kernel in one float64 launch, checked with the fixture test's allclose;
7. drive the PMSM main path: ``PMSM(batch_size=65536, saturated=True,
   motor_variant=BRUSA, tau=1e-4)``, ``env.fused_rollout`` over T = 256 in
   both layouts and with ``obs_stride=16``, and ``env.fused_sim_ahead``
   (RK4); launch counts, shapes, kernel vs plain at full size, and the time
   split between the eager pre-pass and the kernel, plus the kernel alone
   at T = 4,096;
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
   plain at full size, kernel and entry-point times and the bound;
10. hold the PMSM closed-loop kernel (``csrc/pmsm_closed_loop.cu``) against
    its plain version at B = 4,096, T = 64, float32 (and one float64 case),
    tolerance 0.0: P and PI laws on saturated BRUSA and linear DEFAULT,
    deadtime 0 and 1, Euler, RK4 and Tsit5, saves every step and every 16,
    per-batch ``r_s``/``u_dc`` planes and an action band, both noise slabs,
    the linear sensorless tile at deadtime 0 and 1, the gain-scheduled
    sensorless tile, a ragged B;
11. drive the PMSM closed-loop main cases at full width (saturated BRUSA,
    B = 65,536, float32, Euler, ``tau = 1e-4``, deadtime 1): A the P law and
    B the PI law through ``env.fused_closed_loop`` over T = 2,048; C the
    gain-scheduled sensorless tile at ``omega_el = 1200`` with a 3 A sensor
    slab drawn on the card through ``pmsm_closed_loop`` over T = 2,048, with
    its settling error and belief RMSE; D the PI law through
    ``RolloutCollector.collect_policy_fused`` over T = 256; each with one
    launch, kernel vs plain at full size, kernel and entry-point times and
    the bound;
12. hold ``fast_math=True`` in the stepper and closed-loop kernels against
    the plain versions at B = 65,536, T = 64 (Pendulum Euler and RK4 in step
    and sim-ahead modes, CartPole Tsit5, one float64 case, the PD law, ragged
    B), tolerance 0.0, then time the fast pendulum's step mode and PD law at
    T = 4,096;
13. the fast pendulum kernel (``csrc/pendulum_fast.cu``): kernel vs plain at
    0.0 (both layouts, a ragged B), the main case ``Pendulum(batch_size=65536,
    tau=1e-4)`` over T = 4,096 through ``pendulum_fast_rollout`` in both
    layouts with one launch each, bench.py's gate (six chained rollouts
    within 1e-2 rad of the exact chain) and the sustained T = 16,384 slab;
14. the trig-free PMSM kernel (``csrc/pmsm_fast.cu``): kernel vs plain at 0.0
    (B = 4,096, T = 64, DEFAULT, BRUSA and SEW, deadtime 0 and 1, both
    layouts, float64, ragged B), the main case saturated BRUSA B = 65,536,
    T = 256 through ``env.fast_rollout`` in both layouts with one launch
    each, its deviation from the exact ``env.fused_rollout`` (float32 within
    1e-4 over T = 32; over T = 256 float64 within 1e-9, and the float32 fast
    path no farther from the float64 exact path than 4 times the float32
    exact path is; a holding fleet that stays inside its current bands
    within 1e-3 in float32 over T = 256) and the kernel alone at T = 4,096;
15. print the kernel table, the card's name and power limit, and last the
    result line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
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


def time_ms(fn, reps=5, warmup=1):
    """Median time of ``fn`` over ``reps`` runs, CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs(xs, ys):
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(xs, ys))


def entry(name, launches, err, ms, plain_ms, bound_ms, bound_by, source, replaces):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def roofline(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ode_ops(env):
    """Operations of one vector-field evaluation, counted from
    csrc/classic_envs.cuh: each add, multiply, divide, compare and each
    sin/cos/sign call as one; with fast_math each poly_sin is 16 operations,
    each wrap_angle_fast 5, the cosine's shift 1 and fast_sign 3."""
    if getattr(env, "fast_math", False):
        return {0: 3 + 21, 1: 5, 2: 28 + 21 + 22 + 3}[env._kernel_env_id]
    return {0: 4, 1: 5, 2: 31}[env._kernel_env_id]


def ops_per_step(env, solver, sim_ahead):
    """Arithmetic operations of one step of one instance, counting each add,
    multiply, divide, compare and each sin/cos/fmod call as one (the wrap,
    exact or fast, as 5)."""
    from exciting_environments_torch.ops.kernels.stepper import _stage_rows

    a_rows, b = _stage_rows(solver)
    n = len(env._ode_state_fields)
    comb = lambda coeffs: sum(2 - (c == 1.0) for c in coeffs if c != 0.0) + 1 if any(coeffs) else 0
    per_step = 4 * env.action_dim * (2 if sim_ahead else 1)  # in-kernel denormalization
    per_step += len(b) * ode_ops(env) + n * (sum(comb(r) for r in a_rows) + comb(b))
    if not sim_ahead:
        per_step += 5 * len(env._angle_fields)  # wrap: add, fmod, compare, add, sub
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
        families = ("AffineLaw", "ActorLaw", "AffineAdapter", "SensorlessLaw", "ScheduledLaw")
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
    ]
    failures = []
    for label, env, kw in cases:
        kw = dict(kw)
        hold = kw.get("hold", 1)
        y0 = random_state(env, gen)
        acts = random_actions(env, T // hold, gen)
        if kw.pop("noise", False):
            kw["noise_tm"] = (0.01 * torch.randn((T, env.batch_size, 2), generator=gen, device=DEVICE)).to(env.dtype)
            kw["noise_idx"] = (0, 1)
        tau = env.tau
        yk, tk = K.kernel_rollout(env, y0, acts, tau=tau, **kw)
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

    ms = time_ms(step_kernel)
    sa_ms = time_ms(sa_kernel)
    env_tm_ms = time_ms(lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True))
    env_bm_ms = time_ms(lambda: env.fused_rollout(state, actions_bm, strict=True))
    t_short = 256
    t0 = time.perf_counter()
    env.vmap_rollout(state, actions_bm[:, :t_short], t_short)
    torch.cuda.synchronize()
    vmap_ms = (time.perf_counter() - t0) * 1e3

    bound_ms, bound_by = bound(env, env._solver, B, T, T, 0, False)
    sa_bound_ms, sa_bound_by = bound(env_sa, env_sa._solver, B, T, T, T // sa_stride, True)
    steps = B * T
    slab_bytes = actions_tm.numel() * actions_tm.element_size()
    log(f"[main] kernel (time-major slab): {ms!r} ms = {steps / ms * 1e3:.4e} env-steps/s; "
        f"bound {bound_ms!r} ms ({bound_by}); {bound_ms / ms:.1%} of the bound; "
        f"slab read at {slab_bytes / ms / 1e9:.3f} TB/s")
    log(f"[main] env.fused_rollout time-major: {env_tm_ms!r} ms = {steps / env_tm_ms * 1e3:.4e} env-steps/s")
    log(f"[main] env.fused_rollout batch-major (transposed copy): {env_bm_ms!r} ms = "
        f"{steps / env_bm_ms * 1e3:.4e} env-steps/s")
    log(f"[main] plain version, T={T}: {plain_ms!r} ms (one run)")
    log(f"[main] sim-ahead rk4 kernel: {sa_ms!r} ms; bound {sa_bound_ms!r} ms ({sa_bound_by}); "
        f"plain {plain_sa_ms!r} ms (one run)")
    log(f"[main] vmap_rollout, T={t_short}: {vmap_ms!r} ms (one run) = "
        f"{B * t_short / vmap_ms * 1e3:.4e} env-steps/s")
    return [
        entry("stepper_step", launches["step"], err_step, ms, plain_ms, bound_ms, bound_by, SOURCE, REPLACES),
        entry("stepper_sim_ahead", launches["sim_ahead"], err_sa, sa_ms, plain_sa_ms, sa_bound_ms, sa_bound_by,
              SOURCE, REPLACES),
    ]


# ---------------------------------------------------------------------------
# PMSM drive phases
# ---------------------------------------------------------------------------


def pmsm_ops(env, solver, n_steps, n_saves):
    """Arithmetic operations of one instance over a rollout of the PMSM
    kernel, counted from csrc/pmsm_stepper.cu with each add, multiply,
    divide, negation, compare, floor and clamp bound as one."""
    from exciting_environments_torch.ops.kernels.stepper import _stage_rows

    gather = 4 + 2 + 4 + 2 + 2 + 6 * 11  # offsets and scales, floor, clamp, weights, 6 blends
    saturated = bool(env.env_properties.saturated)
    ode = gather + 23 if saturated else 13
    torque = gather + 4 if saturated else 4
    a_rows, b = _stage_rows(solver)
    comb = lambda coeffs: sum(2 - (c == 1.0) for c in coeffs if c != 0.0) + 1 if any(coeffs) else 0
    per_step = len(b) * ode + 2 * (sum(comb(r) for r in a_rows) + comb(b))
    return per_step * n_steps + torque * (n_saves + 1)


def pmsm_bound(env, solver, batch, n_steps, n_saves, itemsize=4):
    """Least time for the PMSM kernel's work: the voltage stream, the initial
    state and buffers, per-batch parameters and the table read once, the
    final state and the saves written once; or its operations at the float32
    rate, whichever is larger."""
    from exciting_environments_torch.ops.kernels.pmsm_stepper import PMSM_PARAMS

    params = env.env_properties.static_params
    n_pb = sum(isinstance(getattr(params, n), torch.Tensor) for n in PMSM_PARAMS)
    lut = env._lut.values.numel() if env._lut is not None else 0
    nbytes = itemsize * (n_steps * batch * 2 + (5 + n_pb) * batch + lut + 3 * batch + 3 * n_saves * batch)
    ops = pmsm_ops(env, solver, n_steps, n_saves) * batch
    return roofline(nbytes, ops)


def pmsm_env(ex, batch, variant="BRUSA", saturated=True, dtype=torch.float32, static=None, **kwargs):
    params = None
    if static:
        params = dict(ex.MotorVariant[variant].get_params().static_params.__dict__)
        if saturated:
            params.update(l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"))
        params.update(static)
    return ex.PMSM(batch_size=batch, saturated=saturated, motor_variant=ex.MotorVariant[variant],
                   static_params=params, device=DEVICE, dtype=dtype, **kwargs)


def pmsm_inputs(env, n_steps, gen, sim_ahead=False, lim=0.9):
    """A reset state and the constrained voltage stream of uniform actions
    in +-lim, through the same pre-pass as env.fused_rollout."""
    from exciting_environments_torch.models.pmsm.pmsm_env import extrapolated_angles
    from exciting_environments_torch.ops.kernels import pmsm_stepper as PK

    _, state = env.vmap_reset(rng=gen)
    u = torch.rand((n_steps, env.batch_size, 2), generator=gen, device=DEVICE, dtype=torch.float64)
    acts = ((u * 2 - 1) * lim).to(env.dtype)
    phys = state.physical_state
    if sim_ahead:
        eps = extrapolated_angles(phys.epsilon, phys.omega_el, env.tau, n_steps)
        u_con = PK._constraint_denorm_batched(env, env.env_properties, acts, eps, phys.omega_el)
    else:
        u_con, _, _ = PK._constrained_voltages(env, state, acts, env.env_properties)
    return state, acts, u_con


def pmsm_run(PK, env, state, u_con, kernel, **kw):
    phys = state.physical_state
    fn = PK.pmsm_kernel_rollout if kernel else PK.plain_pmsm_rollout
    return fn(env, u_con, phys.i_d, phys.i_q, phys.omega_el, (phys.u_d_buffer, phys.u_q_buffer),
              tau=env.tau, **kw)


def pmsm_deviation(PK, env, state, u_con, **kw):
    yk, tk = pmsm_run(PK, env, state, u_con, True, **kw)
    yp, tp = pmsm_run(PK, env, state, u_con, False, **kw)
    torch.cuda.synchronize()
    err = max_abs(yk, yp)
    if tk is not None:
        err = max(err, max_abs(tk, tp))
    return err, all(bool(torch.isfinite(y).all()) for y in yk)


def phase_pmsm_kernel_vs_plain(ex, PK):
    """PMSM kernel against its plain version, B = 65,536, T = 64, tolerance 0.0."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    B, T = B_MAIN, T_CHECK
    uni = lambda lo, hi: (lo + (hi - lo) * torch.rand(B, generator=gen, device=DEVICE, dtype=torch.float64)).float()
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
        ("BRUSA saturated euler obs_stride=4", pmsm_env(ex, B), {"obs_stride": 4}),
        ("BRUSA saturated rk4 sim-ahead deadtime 1", pmsm_env(ex, B, solver="rk4"),
         {"sim_ahead": True, "obs_stride": 1}),
        ("BRUSA saturated euler ragged B=1000", pmsm_env(ex, 1000), {}),
        ("BRUSA saturated rk4 float64 (dynamic shared memory above 48 KB)",
         pmsm_env(ex, B, dtype=torch.float64, solver="rk4"), {"obs_stride": 8}),
    ]
    failures = []
    for label, env, kw in cases:
        state, _, u_con = pmsm_inputs(env, T, gen, sim_ahead=kw.get("sim_ahead", False))
        err, finite = pmsm_deviation(PK, env, state, u_con, **kw)
        ok = finite and err == 0.0
        log(f"[pmsm kernel vs plain] {label}: max abs deviation {err!r} (tolerance 0.0) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"PMSM kernel disagrees with its plain version: {failures}")


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


def phase_pmsm_main(ex, PK):
    """PMSM main path at full width: BRUSA saturated, B = 65,536, T = 256,
    float32; returns the kernel table entries."""
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

    PK.KERNEL.reset_counts()
    obs_tm, last_tm = env.fused_rollout(state, actions_tm, time_major=True, strict=True)
    obs_bm, last_bm = env.fused_rollout(state, actions, strict=True)
    obs_tr, _ = env.fused_rollout(state, actions, obs_stride=stride, strict=True)
    obs_sa, last_sa = env_sa.fused_sim_ahead(state, actions, env_sa.tau, env_sa.tau, strict=True)
    torch.cuda.synchronize()
    launches = dict(PK.KERNEL.launches)
    log(f"[pmsm main] launches during the main path: {launches}")
    if launches["pmsm_step"] < 1 or launches["pmsm_sim_ahead"] < 1:
        raise AssertionError(f"the PMSM main path did not go through the kernel: {launches}")
    shapes = (tuple(obs_tm.shape), tuple(obs_tr.shape), tuple(obs_sa.shape))
    if shapes != ((B, 8), (B, T // stride, 8), (B, T + 1, 8)):
        raise AssertionError(f"unexpected shapes {shapes}")
    if not all(bool(torch.isfinite(o).all()) for o in (obs_tm, obs_tr, obs_sa)):
        raise AssertionError("non-finite observations on the PMSM main path")
    if not (torch.equal(obs_tm, obs_bm) and torch.equal(last_tm.physical_state.i_d, last_bm.physical_state.i_d)):
        raise AssertionError("time-major and batch-major layouts disagree")
    if not torch.equal(obs_tr[:, -1], obs_tm):
        raise AssertionError("the last strided observation differs from the final one")

    props = env.env_properties
    prepass = lambda: PK._constrained_voltages(env, state, actions_tm, props)
    u_con, _, _ = prepass()
    phys = state.physical_state
    eps_ext = ex.models.pmsm.pmsm_env.extrapolated_angles(phys.epsilon, phys.omega_el, env.tau, T)
    u_con_sa = PK._constraint_denorm_batched(env_sa, props, actions_tm, eps_ext, phys.omega_el)
    step_kernel = lambda: pmsm_run(PK, env, state, u_con, True)
    sa_kernel = lambda: pmsm_run(PK, env_sa, state, u_con_sa, True, obs_stride=1, sim_ahead=True)
    err_step, _ = pmsm_deviation(PK, env, state, u_con)
    err_sa, _ = pmsm_deviation(PK, env_sa, state, u_con_sa, obs_stride=1, sim_ahead=True)
    log(f"[pmsm main] kernel vs plain at full size: step max abs {err_step!r}, sim-ahead max abs {err_sa!r}")
    if err_step != 0.0 or err_sa != 0.0:
        raise AssertionError("PMSM kernel disagrees with its plain version at the main size")

    t0 = time.perf_counter()
    pmsm_run(PK, env, state, u_con, False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pmsm_run(PK, env_sa, state, u_con_sa, False, obs_stride=1, sim_ahead=True)
    torch.cuda.synchronize()
    plain_sa_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    env.vmap_rollout(state, actions, T)
    torch.cuda.synchronize()
    vmap_ms = (time.perf_counter() - t0) * 1e3

    ms = time_ms(step_kernel)
    sa_ms = time_ms(sa_kernel)
    prepass_ms = time_ms(prepass)
    env_tm_ms = time_ms(lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True))
    env_bm_ms = time_ms(lambda: env.fused_rollout(state, actions, strict=True))
    env_sa_ms = time_ms(lambda: env_sa.fused_sim_ahead(state, actions, env_sa.tau, env_sa.tau, strict=True))

    # the kernel alone over a long synthetic stream of physical voltages
    # (no pre-pass), so that launch overhead drops out
    u_long = ((torch.rand((T_PMSM_LONG, B, 2), generator=gen, device=DEVICE) * 2 - 1) * 150.0).contiguous()
    long_kernel = lambda: pmsm_run(PK, env, state, u_long, True)
    long_ms = time_ms(long_kernel, reps=3)
    del u_long
    long_bound_ms, long_bound_by = pmsm_bound(env, env._solver, B, T_PMSM_LONG, 0)

    bound_ms, bound_by = pmsm_bound(env, env._solver, B, T, 0)
    sa_bound_ms, sa_bound_by = pmsm_bound(env_sa, env_sa._solver, B, T, T)
    steps = B * T
    log(f"[pmsm main] kernel alone, euler step mode: {ms!r} ms = {steps / ms * 1e3:.4e} env-steps/s; "
        f"bound {bound_ms!r} ms ({bound_by}); {bound_ms / ms:.1%} of the bound")
    log(f"[pmsm main] eager pre-pass alone (angle loop + constraint over (T, B)): {prepass_ms!r} ms")
    log(f"[pmsm main] env.fused_rollout time-major: {env_tm_ms!r} ms = {steps / env_tm_ms * 1e3:.4e} env-steps/s "
        f"(kernel {ms / env_tm_ms:.1%}, pre-pass {prepass_ms / env_tm_ms:.1%})")
    log(f"[pmsm main] env.fused_rollout batch-major: {env_bm_ms!r} ms = {steps / env_bm_ms * 1e3:.4e} env-steps/s")
    log(f"[pmsm main] sim-ahead rk4 kernel alone: {sa_ms!r} ms; bound {sa_bound_ms!r} ms ({sa_bound_by}); "
        f"env.fused_sim_ahead {env_sa_ms!r} ms")
    log(f"[pmsm main] plain version: step {plain_ms!r} ms, sim-ahead {plain_sa_ms!r} ms (one run each)")
    log(f"[pmsm main] vmap_rollout, T={T}: {vmap_ms!r} ms (one run) = {steps / vmap_ms * 1e3:.4e} env-steps/s")
    log(f"[pmsm main] kernel alone, T={T_PMSM_LONG} synthetic voltages: {long_ms!r} ms = "
        f"{B * T_PMSM_LONG / long_ms * 1e3:.4e} env-steps/s; bound {long_bound_ms!r} ms ({long_bound_by}); "
        f"{long_bound_ms / long_ms:.1%} of the bound")
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
    if spec.policy_id == 0:  # AffineLaw
        per_action = 2 * spec.n_obs + (2 * spec.n_obs + 1) * o["has_integral"] + 2 * o["has_clip"]
        return n_action * per_action
    widths = o["widths"]
    ops = sum(2 * m * n for m, n in zip(widths[:-1], widths[1:])) + sum(widths[1:-1]) + 1
    hash_ops = 8 + 2 * 8 + 3 + 2 + 3 + 6  # counter, two mix32, shifts and salt, conversions, uniforms, Box-Muller
    return ops + n_action * (2 + (0 if o["deterministic"] else hash_ops + 3))


def cl_bound(env, spec, batch, n_steps, n_saves, n_carry, n_refs, n_obs_noise=0, n_proc_noise=0, itemsize=4):
    """Least time for the closed-loop kernel's work: its inputs (state,
    references, carry, per-batch parameters, policy parameters, noise slabs)
    read once and its outputs (final state and carry, saves) written once,
    over the memory rate; or its operations over the float32 rate (integer
    operations counted at that rate too), whichever is larger."""
    from exciting_environments_torch.ops.kernels.stepper import _stage_rows

    n, a = len(env._ode_state_fields), env.action_dim
    params = env.env_properties.static_params
    n_pb = sum(isinstance(getattr(params, p), torch.Tensor) for p in env._kernel_params)
    nbytes = itemsize * (batch * (2 * n + n_refs + 2 * n_carry + n_pb) + spec.flat.numel()
                         + n_saves * batch * (n + a + n_carry) + n_steps * batch * (n_obs_noise + n_proc_noise))
    a_rows, b = _stage_rows(env._solver)
    comb = lambda coeffs: sum(2 - (c == 1.0) for c in coeffs if c != 0.0) + 1 if any(coeffs) else 0
    wrap = 5 * len(env._angle_fields)
    per_step = 4 * n + n_obs_noise + cl_policy_ops(spec, a) + 4 * a
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

    def run_case(name, drive, kernel_fn, plain_fn, check, spec, n_steps, n_saves, n_carry, cl_env):
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
             check_final, pd.kernel_spec(torch.float32, DEVICE), T, 0, 0, env)
    run_case("closed_loop_pi", lambda: env.fused_closed_loop(state, pi, T, policy_carry=c0),
             lambda: CL.kernel_closed_loop(env, y0, pi, T, policy_carry=c0, **kw),
             lambda: CL.plain_closed_loop(env, y0, pi, T, policy_carry=c0, **kw),
             lambda out: check_final(out, 1), pi.kernel_spec(torch.float32, DEVICE), T, 0, 1, env)

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
             check_batch, actor.kernel_spec(torch.float32, DEVICE, weights), T_RL, T_RL, 1, rl_env)
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
    torque = gather(6) + 4 if saturated else 4
    obs = 5 * 4 + 2 + n_obs_noise  # five normalized columns (omega once per run), cos, sin
    sched = (8 + gather(n_sched)) if n_sched else 0
    if spec.policy_id == 0:
        o = spec.options
        policy = 2 * (2 * spec.n_obs + (2 * spec.n_obs + 1) * o["has_integral"] + 2 * o["has_clip"])
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
    if omega is not None:
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
        ("DEFAULT linear sensorless tile deadtime 0", sensorless_env(0), "linear", {"traj_stride": 1},
         OMEGA_SENSORLESS),
        ("DEFAULT linear rk4 sensorless tile deadtime 1", sensorless_env(1, "rk4"), "linear", {"traj_stride": 4},
         OMEGA_SENSORLESS),
        ("BRUSA scheduled sensorless tile deadtime 1", sched_env, sched_tile, {"traj_stride": 1, "sched_lut": sched_lut},
         OMEGA_SENSORLESS),
        ("BRUSA rk4 PI float64 (shared memory above 48 KB)", tracking(solver="rk4", dtype=torch.float64), pi_law,
         {"traj_stride": 8}, None),
        ("BRUSA euler P ragged B=1000", pmsm_env(ex, 1000, control_state=["i_d", "i_q"]), p_law, {}, None),
    ]
    failures = []
    for label, env, policy, kw, omega in cases:
        kw = dict(kw)
        if policy == "linear":
            policy, carry0 = ex.make_pmsm_sensorless_current_tile(
                env, i_d_ref=-30.0, i_q_ref=60.0, omega_el=omega, measurement_std={"i_d": 5.0, "i_q": 5.0})
            kw["policy_carry"] = carry0
        elif policy is sched_tile:
            kw["policy_carry"] = sched_c0
        elif policy.n_carry:
            kw["policy_carry"] = tuple(torch.zeros(env.batch_size, device=DEVICE, dtype=env.dtype) for _ in range(2))
        _, state0, omega_t, refs = pcl_inputs(env, gen, omega)
        if policy.policy_id:
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

    def run_case(name, drive, kernel_fn, plain_fn, check, bound_args, n_steps):
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
        entries.append(entry(name, launches, err, ms, plain_ms, bound_ms, bound_by, PCL_SOURCE, PCL_REPLACES))

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
    run_case("pmsm_closed_loop_p", lambda: env.fused_closed_loop(state, p_law, T),
             lambda: PCL.kernel_pmsm_closed_loop(env, state0, omega, p_law, T, **kw),
             lambda: PCL.plain_pmsm_closed_loop(env, state0, omega, p_law, T, **kw), check_final,
             (env, p_law.kernel_spec(torch.float32, DEVICE), B, T, 0, 0, 2), T)
    c0 = zeros2()
    run_case("pmsm_closed_loop_pi", lambda: env.fused_closed_loop(state, pi_law, T, policy_carry=c0),
             lambda: PCL.kernel_pmsm_closed_loop(env, state0, omega, pi_law, T, policy_carry=c0, **kw),
             lambda: PCL.plain_pmsm_closed_loop(env, state0, omega, pi_law, T, policy_carry=c0, **kw),
             lambda out: check_final(out, 1), (env, pi_law.kernel_spec(torch.float32, DEVICE), B, T, 0, 2, 2), T)

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
             (senv, tile.kernel_spec(torch.float32, DEVICE), B, T, 0, 6, 0, 10, 2), T)
    del slab, skw

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
             (env, pi_law.kernel_spec(torch.float32, DEVICE), B, T_D, T_D, 2, 2), T_D)
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
    entries.append(entry("closed_loop_pd_fast", cl_launches, cl_err, cl_ms, cl_plain_ms, cl_bound_ms, cl_bound_by,
                         CL_SOURCE, CL_REPLACES))
    return entries


def phase_pendulum_fast(ex, PFK):
    """Kernel 5: kernel vs plain at 0.0 (B = 65,536 and a ragged B, T = 64,
    both layouts); the main case Pendulum(batch_size=65536, tau=1e-4), actions
    in +-1, T = 4,096 in both layouts; the bench gate against six chained
    exact rollouts; the sustained T = 16,384 time-major slab.  Returns the
    kernel table entry."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    uniform = lambda *shape: torch.rand(shape, generator=gen, device=DEVICE) * 2 - 1

    def plain(env, state, acts_tm):
        phys = state.physical_state
        return PFK.plain_pendulum_fast_rollout(phys.theta, phys.omega, acts_tm[..., 0], **PFK.fast_constants(env))

    failures = []
    for label, batch, time_major in (("B=65536 batch-major", B_MAIN, False), ("B=65536 time-major", B_MAIN, True),
                                     ("ragged B=65531 time-major", B_MAIN - 5, True)):
        env = ex.Pendulum(batch_size=batch, tau=1e-4, device=DEVICE)
        _, state = env.vmap_reset(rng=gen)
        acts_tm = uniform(T_CHECK, batch, 1)
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
    launches = {}
    for layout, acts, tm in (("time-major", actions_tm, True), ("batch-major", actions_bm, False)):
        PFK.KERNEL.reset_counts()
        th, om = ex.pendulum_fast_rollout(env, state, acts, time_major=tm)
        torch.cuda.synchronize()
        launches[layout] = PFK.KERNEL.launches["pendulum_fast"]
        if launches[layout] != 1 or tuple(th.shape) != (B,) or not bool(torch.isfinite(th).all()):
            raise AssertionError(f"the fast pendulum ({layout}) did not run once through its kernel: {launches}")
    log(f"[pendulum fast main] Pendulum B={B} T={T} float32, actions in +-1: launches {launches}")
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
    tm_ms = time_ms(lambda: ex.pendulum_fast_rollout(env, state, actions_tm, time_major=True))
    bm_ms = time_ms(lambda: ex.pendulum_fast_rollout(env, state, actions_bm))
    exact_ms = time_ms(lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True))
    bound_ms, bound_by = roofline(4 * (T * B + 4 * B), PENDULUM_FAST_OPS * B * T)
    steps = B * T
    log(f"[pendulum fast main] kernel: {ms!r} ms = {steps / ms * 1e3:.4e} env-steps/s; bound {bound_ms!r} ms "
        f"({bound_by}); {bound_ms / ms:.1%} of the bound; slab read at {4 * T * B / ms / 1e9:.3f} TB/s")
    log(f"[pendulum fast main] pendulum_fast_rollout time-major {tm_ms!r} ms, batch-major {bm_ms!r} ms; the exact "
        f"env.fused_rollout time-major {exact_ms!r} ms; plain version {plain_ms!r} ms (one run)")

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


def phase_pmsm_fast(ex, PF, PMK):
    """Kernel 6: kernel vs plain at 0.0 (B = 4,096, T = 64, over DEFAULT,
    BRUSA and SEW, deadtime 0 and 1, both layouts, a float64 case, a ragged
    B); the main case, saturated BRUSA B = 65,536, actions in +-0.3, T = 256,
    through env.fast_rollout in both layouts; the deviation from the exact
    env.fused_rollout on that fleet and on a holding fleet inside the
    current bands; the kernel alone on the holding fleet and at T = 4,096.
    Returns the kernel table entry."""
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
        ("BRUSA saturated ragged B=1000 time-major", pmsm_env(ex, 1000), True),
    ]
    failures = []
    for label, env, time_major in cases:
        _, state = env.vmap_reset(rng=gen)
        u = torch.rand((T, env.batch_size, 2), generator=gen, device=DEVICE, dtype=torch.float64)
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
    launches = {}
    finals = {}
    for layout, acts, tm in (("time-major", actions_tm, True), ("batch-major", actions, False)):
        PMK.KERNEL.reset_counts()
        finals[layout] = env.fast_rollout(state, acts, time_major=tm)
        torch.cuda.synchronize()
        launches[layout] = PMK.KERNEL.launches["pmsm_fast"]
        if launches[layout] != 1:
            raise AssertionError(f"env.fast_rollout ({layout}) made {launches[layout]} pmsm_fast launches, not 1")
    a, b = finals["time-major"].physical_state, finals["batch-major"].physical_state
    if not all(torch.equal(getattr(a, n), getattr(b, n)) for n in fields):
        raise AssertionError("time-major and batch-major fast rollouts disagree")
    if not all(bool(torch.isfinite(getattr(a, n)).all()) and tuple(getattr(a, n).shape) == (B,) for n in fields):
        raise AssertionError("non-finite or misshapen fast PMSM state")
    log(f"[pmsm fast main] PMSM BRUSA saturated B={B} T={T} float32, actions in +-0.3: launches {launches}")
    t0 = time.perf_counter()
    ref = PF.pmsm_fast_rollout(env, state, actions_tm, time_major=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs([getattr(a, n) for n in fields], [getattr(ref.physical_state, n) for n in fields])
    if err != 0.0:
        raise AssertionError(f"the fast PMSM kernel disagrees with its plain version at the main size ({err!r})")
    def kernel_args(st, acts_tm):
        """The kernel's own arguments, built as env.fast_rollout builds them."""
        consts, acts_tm, lv = PF.fast_inputs(env, st, acts_tm, True)
        s0 = PF.fast_start(lv["epsilon"], lv["omega_el"], consts)
        return (env, acts_tm, lv["i_d"], lv["i_q"], s0[0], s0[1], lv["u_d_buffer"], lv["u_q_buffer"], lv["omega_el"],
                s0[2], s0[3], consts)

    args = kernel_args(state, actions_tm)
    ms = time_ms(lambda: PMK.kernel_pmsm_fast_rollout(*args))
    tm_ms = time_ms(lambda: env.fast_rollout(state, actions_tm, time_major=True))
    bm_ms = time_ms(lambda: env.fast_rollout(state, actions))
    exact_ms = time_ms(lambda: env.fused_rollout(state, actions_tm, time_major=True, strict=True))
    bound_ms, bound_by = pmsm_fast_bound(env, B, T)
    steps = B * T
    log(f"[pmsm fast main] kernel alone: {ms!r} ms = {steps / ms * 1e3:.4e} env-steps/s; bound {bound_ms!r} ms "
        f"({bound_by}); {bound_ms / ms:.1%} of the bound")
    log(f"[pmsm fast main] env.fast_rollout time-major {tm_ms!r} ms = {steps / tm_ms * 1e3:.4e} env-steps/s "
        f"(kernel {ms / tm_ms:.1%}), batch-major {bm_ms!r} ms; the exact env.fused_rollout time-major {exact_ms!r} ms; "
        f"plain version {plain_ms!r} ms (one run)")

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
    hold_args = kernel_args(hold_state, hold_actions.transpose(0, 1).contiguous())
    hold_ms = time_ms(lambda: PMK.kernel_pmsm_fast_rollout(*hold_args))
    log(f"[pmsm fast main] kernel alone on the holding fleet (gathers inside the table), T={T}: {hold_ms!r} ms "
        f"(random fleet {ms!r} ms)")
    del hold_actions, hold_args

    a_long = ((torch.rand((T_PMSM_LONG, B, 2), generator=gen, device=DEVICE) * 2 - 1) * 0.3).contiguous()
    long_args = kernel_args(state, a_long)
    long_ms = time_ms(lambda: PMK.kernel_pmsm_fast_rollout(*long_args), reps=3)
    long_bound, long_by = pmsm_fast_bound(env, B, T_PMSM_LONG)
    log(f"[pmsm fast main] kernel alone, T={T_PMSM_LONG}: {long_ms!r} ms = {B * T_PMSM_LONG / long_ms * 1e3:.4e} "
        f"env-steps/s; bound {long_bound!r} ms ({long_by}); {long_bound / long_ms:.1%} of the bound")
    del a_long, long_args
    return [entry("pmsm_fast", launches["time-major"], err, ms, plain_ms, bound_ms, bound_by,
                  PMSM_FAST_SOURCE, PMSM_FAST_REPLACES)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
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
    phase_build(K)
    phase_kernel_vs_plain(ex, K)
    phase_golden(ex, K)
    kernels = phase_main(ex, K)
    phase_pmsm_kernel_vs_plain(ex, PK)
    phase_pmsm_golden(ex, PK)
    kernels += phase_pmsm_main(ex, PK)
    phase_cl_kernel_vs_plain(ex, CL)
    kernels += phase_cl_main(ex, CL)
    phase_pcl_kernel_vs_plain(ex, PCL)
    kernels += phase_pcl_main(ex, PCL)
    kernels += phase_fast_flag(ex, K, CL)
    kernels += phase_pendulum_fast(ex, PFK)
    kernels += phase_pmsm_fast(ex, PF, PMK)
    if "jax" in sys.modules or any(m.startswith("exciting_environments_tpu") for m in sys.modules):
        raise AssertionError("the port pulled in JAX or the JAX package")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
