"""Time one case in several checkouts, in the order given, on one CUDA card.

    python3 scripts/compare_checkouts.py CASE CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a directory holding an ``exciting_environments_torch``
package (a ``git archive`` of a commit, or a variant of one).  Name a
checkout more than once to alternate them (A B B A): each name runs in a
fresh process, in turn, after every distinct checkout's kernel libraries
were built (one process per checkout, all started together).  Each run
makes the same data from the seed and times with ``chip_smoke.py``'s
``time_ms`` (medians of CUDA-event timings after a warm-up); then each
checkout's median over its runs is printed.  The last lines are the card's
name and power limit and one JSON object with every run.

Cases:

``fast_fleets``
    The fast PMSM kernel (``csrc/pmsm_fast.cu``) on two fleets: saturated
    BRUSA, B = 65,536, T = 256, float32, actions in +-0.3 (``chip_smoke.py``
    phase 14's main case), and ``chip_smoke.py``'s holding fleet, whose
    drives stay inside their current bands and so gather all over the table
    (the random fleet's drives run away to the table's edge cells).  On
    each fleet, medians of 5 timings over one call and per call over ten
    calls back to back, of the kernel alone (``kernel_pmsm_fast_rollout``)
    on a time-major and on a batch-major slab, and of ``PMSM.fast_rollout``
    on either layout.  A checkout whose kernel reads only time-major slabs
    and takes its start from ``fast_start`` gets its time-major arguments
    and no batch-major time.  Each run also prints a digest of the final
    states of ``PMSM.fast_rollout``: every checkout of one semantics gives
    the same bits.

``rings``
    The two kernels that read their actions through the action ring of
    ``csrc/action_ring.cuh``, at ``chip_smoke.py``'s main sizes in float32,
    B = 65,536, T = 4,096: the fast pendulum (``kernel_pendulum_fast_rollout``,
    one call and per call over ten back to back, on a time-major and a
    batch-major slab; PERF.md section 6 row 5) and the stepper on the
    pendulum (``kernel_rollout``, Euler, both layouts; row 1a).  Medians of
    11 timings.

``closed_loops``
    The closed-loop kernel (``csrc/closed_loop.cu``) with the policy
    families of its earlier rows, at ``chip_smoke.py``'s main cases in
    float32, B = 65,536 (PERF.md section 6): the tracking pendulum with the
    PD and the PI law over T = 4,096 (rows 2a, 2b), the (16, 16) actor with
    saves every step over T = 64 at tau = 2e-2 (2c), the PD law with
    ``fast_math=True`` (2d), the Acrobot PD law (2e) and the induction
    machine's PI law with ``u_dc = 400`` (2f) over T = 4,096.  Medians of 11
    timings of ``kernel_closed_loop``.

``sched_ladder``
    The PMSM closed-loop kernel (``csrc/pmsm_closed_loop.cu``) with the
    gain-scheduled sensorless tile of ``utils/foc.py`` at the benchmark cell
    ``pmsm-brusa-sched-sensorless-fleet-t2048``'s size, float32, B = 65,536,
    T = 2,048, from drawn starts with a cold observer: the scalar tile at one
    operating point (500 rad/s, -100 A, 50 A; ``ScheduledLaw``), and the
    per-drive tile (``ScheduledDriveLaw``) at that point, over one slice with
    the references spread, over 32 speed slices at one reference, and over 32
    slices with the references spread (the cell's case; speeds over 0..1,000
    rad/s, references over -200..-10 A and -150..150 A).  Medians of 5
    timings of ``kernel_pmsm_closed_loop``, and a digest of each case's
    outputs, which every checkout of one semantics gives alike.  A checkout
    that counts ``SLICE_STAGING`` prints it.

``no_grad_entries``
    The four exact kernels with no input that requires grad, at
    ``chip_smoke.py``'s main cases in float32, B = 65,536: the stepper on
    the pendulum (Euler, T = 4,096, time-major; PERF.md section 6 row 1a),
    the closed loop with the PD law (T = 4,096; row 2a), the PMSM stepper on
    saturated BRUSA (Euler, T = 256, time-major; row 3a) and the PMSM
    closed loop with the P law (T = 2,048; row 4a).  Medians of 11 timings
    of one call, of each kernel's wrapper (``kernel_rollout``,
    ``kernel_closed_loop``, ``pmsm_kernel_rollout``,
    ``kernel_pmsm_closed_loop``) and of the entry point
    (``fused_rollout``, ``fused_closed_loop``), so that a wrapper's host
    work before its launch counts.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B = 65536


def fast_fleets(cs, ex) -> dict:
    import torch
    from exciting_environments_torch.ops import pmsm_fast as PF
    from exciting_environments_torch.ops.kernels import pmsm_fast_kernel as PMK

    T, chain = 256, 10
    gen = torch.Generator(device="cuda").manual_seed(7)
    env = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4, device="cuda")
    _, state = env.vmap_reset(rng=gen)
    u = torch.rand((B, T, 2), generator=gen, device="cuda", dtype=torch.float64)
    fleets = {"random": (state, ((u * 2 - 1) * 0.3).float())}
    del u
    fleets["holding"] = cs.holding_fleet(ex, env, gen, T)

    in_place = hasattr(PMK, "pack_args")

    def kernel_call(st, acts_bm, batch_major):
        if in_place:
            acts = acts_bm if batch_major else acts_bm.transpose(0, 1).contiguous()
            consts, _, lv = PF.fast_inputs(env, st, acts, not batch_major)
            return lambda: PMK.kernel_pmsm_fast_rollout(env, acts, lv, consts, batch_major)
        if batch_major:
            return None
        consts, acts_tm, lv = PF.fast_inputs(env, st, acts_bm.transpose(0, 1).contiguous(), True)
        cA, sA, c_delta, s_delta = PF.fast_start(lv["epsilon"], lv["omega_el"], consts)
        args = (env, acts_tm, lv["i_d"], lv["i_q"], cA, sA, lv["u_d_buffer"], lv["u_q_buffer"], lv["omega_el"],
                c_delta, s_delta, consts)
        return lambda: PMK.kernel_pmsm_fast_rollout(*args)

    times, digest = {}, hashlib.sha256()
    for fleet, (st, acts_bm) in fleets.items():
        acts_tm = acts_bm.transpose(0, 1).contiguous()
        for layout, batch_major in (("time-major", False), ("batch-major", True)):
            call = kernel_call(st, acts_bm, batch_major)
            acts = acts_bm if batch_major else acts_tm
            entry = lambda: env.fast_rollout(st, acts, time_major=not batch_major)
            label = lambda n: "one call" if n == 1 else f"{n} back to back"
            for n in (1, chain):
                times[f"{fleet} kernel {layout} {label(n)}"] = cs.time_ms(call, chain=n) if call else None
            for n in (1, chain):
                times[f"{fleet} fast_rollout {layout} {label(n)}"] = cs.time_ms(entry, chain=n)
            last = entry().physical_state
            for name in ("i_d", "i_q", "epsilon", "torque", "u_d_buffer", "u_q_buffer"):
                digest.update(getattr(last, name).contiguous().cpu().numpy().tobytes())
        del acts_tm
    return {"in_place": in_place, "digest": digest.hexdigest()[:16], "ms": times}


def no_grad_entries(cs, ex) -> dict:
    import torch
    from exciting_environments_torch.ops.kernels import closed_loop as CL
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
    from exciting_environments_torch.ops.kernels import pmsm_stepper as PK
    from exciting_environments_torch.ops.kernels import stepper as K

    gen = torch.Generator(device="cuda").manual_seed(3)
    time_ms = lambda fn: cs.time_ms(fn, reps=11)
    times = {}

    pend = ex.Pendulum(batch_size=B, tau=1e-4, device="cuda")
    _, ps = pend.vmap_reset(rng=gen)
    acts = cs.random_actions(pend, 4096, gen)
    y0 = tuple(getattr(ps.physical_state, n) for n in pend._ode_state_fields)
    times["1a kernel_rollout"] = time_ms(lambda: K.kernel_rollout(pend, y0, acts, tau=pend.tau))
    times["1a env.fused_rollout"] = time_ms(lambda: pend.fused_rollout(ps, acts, time_major=True, strict=True))
    del acts

    track = ex.Pendulum(batch_size=B, control_state=["theta"], device="cuda")
    _, ts = track.vmap_reset(rng=gen)
    ts.reference.theta = torch.linspace(-1.5, 1.5, B, device="cuda")
    pd = ex.AffinePolicy(cs.PD_GAINS)
    refs = (track.env_properties.physical_normalizations.theta.normalize(ts.reference.theta),)
    y0 = tuple(getattr(ts.physical_state, n) for n in track._ode_state_fields)
    kw = dict(tau=track.tau, solver=track._solver, props=track.env_properties, ref_leaves=refs)
    times["2a kernel_closed_loop"] = time_ms(lambda: CL.kernel_closed_loop(track, y0, pd, 4096, **kw))
    times["2a env.fused_closed_loop"] = time_ms(lambda: track.fused_closed_loop(ts, pd, 4096))

    drive = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4, device="cuda")
    state, acts = cs.pmsm_inputs(drive, 256, gen, lim=0.3)
    state0, omega = PK._start(state)
    times["3a pmsm_kernel_rollout"] = time_ms(lambda: PK.pmsm_kernel_rollout(drive, acts, state0, omega,
                                                                             tau=drive.tau))
    times["3a env.fused_rollout"] = time_ms(lambda: drive.fused_rollout(state, acts, time_major=True, strict=True))

    ctrl = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, control_state=["i_d", "i_q"],
                   device="cuda")
    cstate, cstate0, comega, crefs = cs.pcl_inputs(ctrl, gen)
    p_law = ex.AffinePolicy(cs.PCL_P)
    kw = dict(tau=ctrl.tau, solver=ctrl._solver, props=ctrl.env_properties, ref_leaves=crefs)
    times["4a kernel_pmsm_closed_loop"] = time_ms(lambda: PCL.kernel_pmsm_closed_loop(ctrl, cstate0, comega, p_law,
                                                                                      2048, **kw))
    times["4a env.fused_closed_loop"] = time_ms(lambda: ctrl.fused_closed_loop(cstate, p_law, 2048))
    return {"ms": times}


def closed_loops(cs, ex) -> dict:
    import torch
    from exciting_environments_torch.ops.kernels import closed_loop as CL
    from exciting_environments_torch.utils.convert import actor_params_from_numpy

    gen = torch.Generator(device="cuda").manual_seed(7)
    times = {}

    def run(row, env, policy, n_steps, field, ref, **kw):
        _, state = env.vmap_reset(rng=gen)
        y0 = tuple(getattr(state.physical_state, n) for n in env._ode_state_fields)
        refs = (getattr(env.env_properties.physical_normalizations, field).normalize(ref),)
        args = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs, **kw)
        times[row] = cs.time_ms(lambda: CL.kernel_closed_loop(env, y0, policy, n_steps, **args), reps=11)

    zeros = lambda n: tuple(torch.zeros(B, device="cuda") for _ in range(n))
    lin = torch.linspace(-1.5, 1.5, B, device="cuda")
    pend = ex.Pendulum(batch_size=B, control_state=["theta"], device="cuda")
    run("2a PD", pend, ex.AffinePolicy(cs.PD_GAINS), 4096, "theta", lin)
    run("2b PI", pend, ex.AffinePolicy(**cs.PI_LAW), 4096, "theta", lin, policy_carry=zeros(1))
    rl = ex.Pendulum(batch_size=B, tau=2e-2, control_state=["theta"], device="cuda")
    actor, ids = ex.make_actor_tile(rl)
    weights = actor_params_from_numpy(rl, cs.actor_tree(3))
    run("2c actor, saves every step", rl, actor, 64, "theta", lin, traj_stride=1, policy_params=weights,
        policy_carry=ids)
    fast = ex.Pendulum(batch_size=B, control_state=["theta"], fast_math=True, device="cuda")
    run("2d PD fast_math", fast, ex.AffinePolicy(cs.PD_GAINS), 4096, "theta", lin)
    acro = ex.Acrobot(batch_size=B, control_state=["theta_1"], device="cuda")
    run("2e Acrobot PD", acro, ex.AffinePolicy([[-0.9, 0.0, -0.25, 0.0, 0.9]]), 4096, "theta_1", lin)
    im = ex.InductionMachine(batch_size=B, control_state=["i_sd"], u_dc=cs.U_DC, device="cuda")
    pi = ex.AffinePolicy([[-0.9, 0.0, 0.0, 0.0, 0.9], [0.0, -0.9, 0.0, 0.0, 0.0]], b=[0.3, 0.6],
                         Ki=[[-0.02, 0.0, 0.0, 0.0, 0.02], [0.0, -0.02, 0.0, 0.0, 0.0]], clip=1.0)
    run("2f IM PI u_dc", im, pi, 4096, "i_sd", torch.linspace(-10.0, 10.0, B, device="cuda"), policy_carry=zeros(2))
    return {"ms": times}


def rings(cs, ex) -> dict:
    import torch
    from exciting_environments_torch.ops.kernels import pendulum_fast as PFK
    from exciting_environments_torch.ops.kernels import stepper as K

    gen = torch.Generator(device="cuda").manual_seed(5)
    time_ms = lambda fn, chain=1: cs.time_ms(fn, reps=11, chain=chain)
    env = ex.Pendulum(batch_size=B, tau=1e-4, device="cuda")
    _, state = env.vmap_reset(rng=gen)
    acts_tm = cs.random_actions(env, 4096, gen)
    acts_bm = acts_tm.transpose(0, 1).contiguous()
    phys, consts = state.physical_state, PFK.fast_constants(env)
    y0 = (phys.theta, phys.omega)
    times = {}
    for layout, slab, batch_major in (("time-major", acts_tm, False), ("batch-major", acts_bm, True)):
        fast = lambda: PFK.kernel_pendulum_fast_rollout(phys.theta, phys.omega, slab[..., 0], batch_major=batch_major,
                                                        **consts)
        times[f"5 pendulum_fast {layout} one call"] = time_ms(fast)
        times[f"5 pendulum_fast {layout} 10 back to back"] = time_ms(fast, chain=10)
        times[f"1a kernel_rollout {layout}"] = time_ms(lambda: K.kernel_rollout(env, y0, slab, tau=env.tau,
                                                                                batch_major=batch_major))
    return {"ms": times}


def sched_ladder(cs, ex) -> dict:
    import torch
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL

    T, n_speeds = 2048, 32
    gen = torch.Generator(device="cuda").manual_seed(9)
    env = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4,
                  control_state=["i_d", "i_q"], device="cuda")
    draw = lambda lo, hi: (lo + (hi - lo) * torch.rand(B, generator=gen, device="cuda", dtype=torch.float64)).float()
    speeds = torch.linspace(0.0, 1000.0, n_speeds, device="cuda")
    spread_omega = speeds[torch.randint(0, n_speeds, (B,), generator=gen, device="cuda")]
    spread_refs = (draw(-200.0, -10.0), draw(-150.0, 150.0))
    full = lambda v: torch.full((B,), v, device="cuda")
    point = (500.0, -100.0, 50.0)
    cases = {
        "scalar tile, one point": None,
        "per drive, one point": (full(point[0]), (full(point[1]), full(point[2]))),
        "per drive, one slice, references spread": (full(point[0]), spread_refs),
        "per drive, 32 slices, one reference": (spread_omega, (full(point[1]), full(point[2]))),
        "per drive, 32 slices, references spread (the cell)": (spread_omega, spread_refs),
    }
    sensors = {"i_d": 2.5, "i_q": 2.5}
    pn = env.env_properties.physical_normalizations
    times, digests = {}, {}
    for name, case in cases.items():
        omega, refs = case if case is not None else (full(point[0]), (full(point[1]), full(point[2])))
        if case is None:
            tile, carry0, sched = ex.make_pmsm_saturated_sensorless_current_tile(
                env, i_d_ref=point[1], i_q_ref=point[2], omega_el=point[0], measurement_std=sensors)
        else:
            tile, carry0, sched = ex.make_pmsm_saturated_sensorless_current_tile(
                env, i_d_ref=refs[0], i_q_ref=refs[1], omega_el=omega, measurement_std=sensors)
        _, state0, _, _ = cs.pcl_inputs(env, gen, omega)
        kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, policy_carry=carry0, sched_lut=sched,
                  ref_leaves=(pn.i_d.normalize(refs[0]), pn.i_q.normalize(refs[1])))
        call = lambda: PCL.kernel_pmsm_closed_loop(env, state0, omega, tile, T, **kw)
        times[name] = cs.time_ms(call)
        final, u_last, carry, _, _ = call()
        digest = hashlib.sha256()
        for leaf in (*final, *u_last, *carry):
            digest.update(leaf.contiguous().cpu().numpy().tobytes())
        digests[name] = digest.hexdigest()[:16]
    staging = dict(getattr(PCL, "SLICE_STAGING", {}))
    return {"digest": " ".join(f"{k[:24]}={v}" for k, v in digests.items()), "slice_staging": staging,
            "ms": times}


#: each case's kernel libraries and its run
CASES = {
    "rings": (("stepper", "pendulum_fast"), rings),
    "closed_loops": (("closed_loop",), closed_loops),
    "fast_fleets": (("pmsm_fast",), fast_fleets),
    "no_grad_entries": (("stepper", "closed_loop", "pmsm_stepper", "pmsm_closed_loop"), no_grad_entries),
    "sched_ladder": (("pmsm_closed_loop",), sched_ladder),
}


def build_all(checkouts, libraries):
    """Build the libraries of every distinct checkout, one process each, all
    started together."""
    code = ("import sys; sys.path.insert(0, '.'); "
            f"from exciting_environments_torch.ops.kernels.stepper import build_all; build_all({libraries!r})")
    procs = {c: subprocess.Popen([sys.executable, "-c", code], cwd=c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for c in dict.fromkeys(checkouts)}
    for c, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"building {libraries} in {c} failed:\n{out[-3000:]}")


def run_one(case: str, checkout: str) -> dict:
    """One run of ``case`` on one checkout (this process imports its package)."""
    sys.path.insert(0, str(Path(checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import exciting_environments_torch as ex

    if not Path(ex.__file__).resolve().is_relative_to(Path(checkout).resolve()):
        raise RuntimeError(f"imported {ex.__file__}, not the package of {checkout}")
    return {"checkout": checkout, **CASES[case][1](cs, ex)}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(run_one(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("compare_checkouts: no CUDA device is available", file=sys.stderr)
        return 2
    if len(sys.argv) < 3 or sys.argv[1] not in CASES:
        print(__doc__, file=sys.stderr)
        return 2
    case, checkouts = sys.argv[1], sys.argv[2:]
    t0 = time.perf_counter()
    build_all(checkouts, CASES[case][0])
    print(f"[build] {len(set(checkouts))} checkouts ready in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    for i, c in enumerate(checkouts):
        out = subprocess.run([sys.executable, __file__, "--one", case, c], capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-3000:], file=sys.stderr)
            return 1
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(f"[run {i + 1}] {c}" + (f" digest {run['digest']}" if "digest" in run else "")
              + (f" slice staging {run['slice_staging']}" if run.get("slice_staging") else ""), flush=True)
        for key, ms in run["ms"].items():
            print(f"    {key}: {ms!r} ms", flush=True)
    for key in runs[0]["ms"]:
        per = {c: [r["ms"][key] for r in runs if r["checkout"] == c and r["ms"][key] is not None]
               for c in dict.fromkeys(checkouts)}
        print(f"[median] {key}: " + "; ".join(f"{c} {statistics.median(v)!r} ms of {len(v)}"
                                             for c, v in per.items() if v), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"case": case, "card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
