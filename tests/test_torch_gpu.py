"""The stepper, PMSM, closed-loop and PMSM closed-loop kernels, the fast-math
flag in the first and third, and the fast pendulum and fast PMSM kernels
against their plain versions on a CUDA card.

The kernels have no CPU mode, so these tests carry the ``gpu`` marker and skip
without a card.  The file imports neither JAX nor the JAX package, so on a
machine without JAX it runs with the JAX-free conftest skipped:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import exciting_environments_torch as P
from exciting_environments_torch.ops.kernels import closed_loop as CL
from exciting_environments_torch.ops.kernels import pmsm_stepper as PK
from exciting_environments_torch.ops.kernels import stepper as K

CASES = [
    ("Pendulum", "euler", 1, False),
    ("CartPole", "tsit5", 1, False),
    ("MassSpringDamper", "rk4", 1, False),
    ("Pendulum", "rk4", 1, True),
    ("CartPole", "rk4", 2, True),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("name,solver,hold,sim_ahead", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_version(name, solver, hold, sim_ahead, dtype):
    _cuda()
    env = getattr(P, name)(batch_size=4096 + 77, solver=solver, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    y0 = tuple((torch.rand(env.batch_size, generator=gen, device="cuda", dtype=torch.float64) * 2 - 1).to(dtype)
               for _ in env._ode_state_fields)
    acts = (torch.rand((32 // hold, env.batch_size, 1), generator=gen, device="cuda", dtype=torch.float64)
            * 1.8 - 0.9).to(dtype)
    kw = dict(tau=env.tau, obs_stride=4, sim_ahead=sim_ahead, hold=hold)
    before = dict(K.KERNEL.launches)
    yk, tk = K.kernel_rollout(env, y0, acts, **kw)
    yp, tp = K.plain_rollout(env, y0, acts, **kw)
    torch.cuda.synchronize()
    mode = "sim_ahead" if sim_ahead else "step"
    assert K.KERNEL.launches[mode] == before[mode] + 1
    for a, b in zip(yk + tk, yp + tp):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_do():
    _cuda()
    env = P.Pendulum(batch_size=256)
    y0 = (torch.zeros(256, device="cuda"), torch.zeros(256, device="cuda"))
    acts = torch.zeros((8, 256, 1), device="cuda")
    with pytest.raises(NotImplementedError, match="backward"):
        K.kernel_rollout(env, y0, acts.clone().requires_grad_(True), tau=env.tau)
    with pytest.raises(ValueError, match="float32"):
        K.kernel_rollout(env, y0, acts.double(), tau=env.tau)
    obs, _ = env.fused_rollout(env.vmap_reset()[1], acts.transpose(0, 1), strict=True)
    assert obs.is_cuda and bool(torch.isfinite(obs).all())


@pytest.mark.gpu
def test_golden_pendulum_fixture_through_kernel_float64():
    _cuda()
    from pathlib import Path

    from exciting_environments_torch.utils import load_sim_properties_from_json

    data = Path(__file__).parent / "envs" / "pendulum" / "data"
    params, an, pn, tau = load_sim_properties_from_json(data / "sim_properties.json")
    env = P.Pendulum(batch_size=1, tau=tau, static_params=params, physical_normalizations=pn,
                     action_normalizations=an, dtype=torch.float64)
    stored = torch.as_tensor(np.load(data / "observations.npy"), device="cuda")
    actions = torch.as_tensor(np.load(data / "actions.npy"), device="cuda")
    state = env.generate_state_from_observation(stored[0][None], env.env_properties)
    obs, _ = env.fused_rollout(state, actions[None], obs_stride=1, strict=True)
    generated = torch.cat([stored[:1], obs[0]], dim=0)
    assert torch.allclose(generated, stored, 1e-16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eager_scalar_division_is_a_reciprocal_multiply(dtype):
    """The kernel reproduces PyTorch's CUDA eager division by a Python number:
    a multiply by the reciprocal taken in double and rounded to the working
    type.  If a PyTorch release changes that, this test says so first."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.rand(1 << 16, generator=gen, device="cuda", dtype=torch.float64) * 8 - 4).to(dtype)
    # the pendulum's and cart-pole's divisors, then the PMSM's grid steps and
    # DEFAULT inductances
    for c in (1.1, 0.05, 0.3, 10.0, 1.0, 0.37e-3, 1.2e-3):
        assert torch.equal(x / c, x * torch.tensor(1.0 / c, dtype=dtype, device="cuda"))


PMSM_CASES = [
    ("BRUSA", True, "euler", 1, False, None),
    ("SEW", True, "rk4", 1, False, 2),
    ("BRUSA", True, "tsit5", 0, False, None),
    ("DEFAULT", False, "euler", 1, False, 4),
    ("DEFAULT", False, "rk4", 0, True, 1),
    ("BRUSA", True, "rk4", 1, True, 1),
]


def _pmsm_inputs(env, n_steps, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _, state = env.vmap_reset(rng=gen)
    acts = ((torch.rand((n_steps, env.batch_size, 2), generator=gen, device="cuda", dtype=torch.float64)
             * 1.8 - 0.9).to(env.dtype))
    u_con, _, _ = PK._constrained_voltages(env, state, acts, env.env_properties)
    phys = state.physical_state
    return u_con, (phys.i_d, phys.i_q, phys.omega_el, (phys.u_d_buffer, phys.u_q_buffer))


@pytest.mark.gpu
@pytest.mark.parametrize("variant,saturated,solver,deadtime,sim_ahead,stride", PMSM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pmsm_kernel_matches_plain_version(variant, saturated, solver, deadtime, sim_ahead, stride, dtype):
    _cuda()
    params = dict(P.MotorVariant[variant].get_params().static_params.__dict__, deadtime=deadtime)
    if saturated:
        params.update(l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"))
    env = P.PMSM(batch_size=2048 + 45, saturated=saturated, motor_variant=P.MotorVariant[variant],
                 solver=solver, static_params=params, dtype=dtype)
    u_con, (i_d, i_q, omega, buf0) = _pmsm_inputs(env, 32, 3)
    kw = dict(tau=env.tau, obs_stride=stride, sim_ahead=sim_ahead)
    mode = "pmsm_sim_ahead" if sim_ahead else "pmsm_step"
    before = PK.KERNEL.launches[mode]
    yk, tk = PK.pmsm_kernel_rollout(env, u_con, i_d, i_q, omega, buf0, **kw)
    yp, tp = PK.plain_pmsm_rollout(env, u_con, i_d, i_q, omega, buf0, **kw)
    torch.cuda.synchronize()
    assert PK.KERNEL.launches[mode] == before + 1
    for a, b in zip(yk + (tk or ()), yp + (tp or ())):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_pmsm_per_batch_parameters_match_plain_version():
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    B = 1500
    uni = lambda lo, hi: lo + (hi - lo) * torch.rand(B, generator=gen, device="cuda")
    params = dict(P.MotorVariant.BRUSA.get_params().static_params.__dict__,
                  l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"), r_s=uni(15e-3, 21e-3), p=uni(2.0, 4.0))
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, static_params=params)
    u_con, (i_d, i_q, omega, buf0) = _pmsm_inputs(env, 16, 5)
    yk, _ = PK.pmsm_kernel_rollout(env, u_con, i_d, i_q, omega, buf0, tau=env.tau)
    yp, _ = PK.plain_pmsm_rollout(env, u_con, i_d, i_q, omega, buf0, tau=env.tau)
    for a, b in zip(yk, yp):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_pmsm_refused_launch_raises():
    """A table too large for shared memory is refused at launch, and the
    wrapper raises instead of returning unwritten outputs."""
    _cuda()
    from exciting_environments_torch.ops.lut import StackedBilinearLUT

    env = P.PMSM(batch_size=256, saturated=True, motor_variant=P.MotorVariant.BRUSA, dtype=torch.float64)
    grid = np.linspace(-300.0, 300.0, 120)
    env._lut = StackedBilinearLUT(grid, grid, np.ones((6, 120, 120)), env._lut.channel_names,
                                  device="cuda", dtype=torch.float64)  # 691,200 B
    u_con, (i_d, i_q, omega, buf0) = _pmsm_inputs(env, 4, 6)
    with pytest.raises(RuntimeError, match="launch failed"):
        PK.pmsm_kernel_rollout(env, u_con, i_d, i_q, omega, buf0, tau=env.tau)
    with pytest.raises(NotImplementedError, match="backward"):
        PK.pmsm_kernel_rollout(env, u_con.clone().requires_grad_(True), i_d, i_q, omega, buf0, tau=env.tau)


@pytest.mark.gpu
def test_pmsm_env_paths_run_on_the_card():
    _cuda()
    env = P.PMSM(batch_size=512, saturated=True, motor_variant=P.MotorVariant.BRUSA, solver="rk4")
    _, state = env.vmap_reset(rng=torch.Generator(device="cuda").manual_seed(7))
    acts = 0.3 * torch.ones((512, 8, 2), device="cuda")
    PK.KERNEL.reset_counts()
    obs, last = env.fused_rollout(state, acts, obs_stride=2, strict=True)
    obs_sa, _ = env.fused_sim_ahead(state, acts, env.tau, env.tau, strict=True)
    assert PK.KERNEL.launches == {"pmsm_step": 1, "pmsm_sim_ahead": 1}
    assert obs.shape == (512, 4, 8) and obs_sa.shape == (512, 9, 8)
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(obs_sa).all())


@pytest.mark.gpu
def test_golden_pmsm_fixture_through_kernel_float64():
    _cuda()
    from pathlib import Path

    from exciting_environments_torch.utils import load_sim_properties_from_json

    data = Path(__file__).parent / "envs" / "pmsm" / "data"
    params, an, pn, tau = load_sim_properties_from_json(data / "sim_properties.json")
    env = P.PMSM(batch_size=1, tau=tau, static_params=params, physical_normalizations=pn,
                 action_normalizations=an, dtype=torch.float64)
    stored = torch.as_tensor(np.load(data / "observations.npy"), device="cuda")
    actions = torch.as_tensor(np.load(data / "actions.npy"), device="cuda")
    state = env.generate_state_from_observation(stored[0][None], env.env_properties)
    obs, _ = env.fused_rollout(state, actions[None], obs_stride=1, strict=True)
    generated = torch.cat([stored[:1], obs[0]], dim=0)
    assert torch.allclose(generated, stored, 1e-8)


PD_GAINS = [[-0.9, -0.25, 0.9]]


def _actor_params(env, hidden=(16, 16), seed=0):
    """Actor weights from a numpy seed, carried across as the JAX package's
    actor pytree would be."""
    from exciting_environments_torch.utils.convert import actor_params_from_numpy

    rng = np.random.default_rng(seed)
    sizes = (3, *hidden, 1)
    layers = [{"w": rng.normal(0.0, 1.0 / np.sqrt(m), (m, n)), "b": rng.normal(0.0, 0.1, n)}
              for m, n in zip(sizes[:-1], sizes[1:])]
    return actor_params_from_numpy(env, {"actor": layers, "log_std": np.full(1, -1.0), "seed": 77.0})


def _cl_case(kind, dtype, n_steps):
    """(env, policy, y0, refs, loop kwargs) of one closed-loop case."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    env = P.Pendulum(batch_size=1000 if kind == "ragged" else 2048 + 45, control_state=["theta"], dtype=dtype,
                     solver="rk4" if kind in ("pi", "noise") else "euler", **({"tau": 2e-2} if kind == "actor" else {}))
    rand = lambda *shape: (torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64) * 2 - 1).to(dtype)
    B = env.batch_size
    loop = {"traj_stride": 1}
    if kind == "pi":
        policy = P.AffinePolicy(PD_GAINS, Ki=[[-2e-3, 0.0, 2e-3]], clip=1.0)
        loop["policy_carry"] = (torch.zeros(B, device="cuda", dtype=dtype),)
    elif kind == "actor":
        policy, ids = P.make_actor_tile(env)
        loop.update(policy_carry=ids, policy_params=_actor_params(env))
    else:
        policy = P.AffinePolicy(PD_GAINS)
    if kind == "noise":
        loop.update(obs_noise_tm=0.05 * rand(n_steps, B, 2), obs_noise_cols=(0, 2),
                    proc_noise_tm=0.01 * rand(n_steps, B, 2), proc_noise_idx=(0, 1))
    return env, policy, (rand(B), rand(B)), (rand(B),), loop


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pd", "pi", "actor", "noise", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_closed_loop_kernel_matches_plain_version(kind, dtype):
    _cuda()
    n_steps = 32
    env, policy, y0, refs, loop = _cl_case(kind, dtype, n_steps)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs, **loop)
    before = CL.CL_KERNEL.launches["closed_loop"]
    outk = CL.kernel_closed_loop(env, y0, policy, n_steps, **kw)
    outp = CL.plain_closed_loop(env, y0, policy, n_steps, **kw)
    torch.cuda.synchronize()
    assert CL.CL_KERNEL.launches["closed_loop"] == before + 1
    flat = lambda out: [t for part in out if part is not None for t in part]
    assert len(flat(outk)) == len(flat(outp))
    for a, b in zip(flat(outk), flat(outp)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_closed_loop_entry_points_launch_and_refuse():
    _cuda()
    env = P.Pendulum(batch_size=256, control_state=["theta"])
    _, state = env.vmap_reset(rng=torch.Generator(device="cuda").manual_seed(9))
    state.reference.theta = torch.linspace(-1.0, 1.0, 256, device="cuda")
    pd = P.AffinePolicy(PD_GAINS)
    CL.CL_KERNEL.reset_counts()
    obs, last = env.fused_closed_loop(state, pd, 8)
    batch, _ = P.RolloutCollector(env).collect_policy_fused(pd, state, 8)
    assert CL.CL_KERNEL.launches == {"closed_loop": 2}
    assert obs.is_cuda and obs.shape == (256, 3) and batch.rewards.shape == (256, 8, 1)
    assert bool(torch.isfinite(batch.observations).all())
    with pytest.raises(ValueError, match="plain callable"):
        env.fused_closed_loop(state, lambda obs, t: (-0.9 * obs[0],), 8)
    y0 = (state.physical_state.theta.clone().requires_grad_(True), state.physical_state.omega)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=(state.reference.theta,))
    with pytest.raises(NotImplementedError, match="backward"):
        CL.kernel_closed_loop(env, y0, pd, 8, **kw)
    gains = pd.flat_params().float().cuda().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        CL.kernel_closed_loop(env, (state.physical_state.theta, state.physical_state.omega),
                              P.AffinePolicy(np.zeros((1, 3))), 8,
                              policy_params=gains, **kw)
    assert CL.CL_KERNEL.launches == {"closed_loop": 2}


PCL_P = [[-0.6, 0, 0, 0, 0, 0, 0, 0, 0.6, 0], [0, -0.6, 0, 0, 0, 0, 0, 0, 0, 0.6]]
PCL_KI = [[-0.01, 0, 0, 0, 0, 0, 0, 0, 0.01, 0], [0, -0.01, 0, 0, 0, 0, 0, 0, 0, 0.01]]


def _pcl_case(kind, dtype, n_steps):
    """(env, policy, state0, omega, loop kwargs) of one PMSM closed-loop case."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    B = 2048 + 45
    saturated = kind != "linear"
    variant = P.MotorVariant.BRUSA if saturated else P.MotorVariant.DEFAULT
    params = dict(variant.get_params().static_params.__dict__)
    if saturated:
        params.update(l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"))
    if kind == "per_batch":
        params.update(r_s=0.015 + 0.006 * torch.rand(B, generator=gen, device="cuda", dtype=dtype),
                      u_dc=350.0 + 100.0 * torch.rand(B, generator=gen, device="cuda", dtype=dtype))
    control = ["i_d", "i_q"] if kind in ("p", "pi", "per_batch") else []
    env = P.PMSM(batch_size=B, saturated=saturated, motor_variant=variant, static_params=params, dtype=dtype,
                 solver="rk4" if kind == "pi" else "euler", control_state=control)
    _, state = env.vmap_reset(rng=gen)
    phys = state.physical_state
    pn = env.env_properties.physical_normalizations
    loop = {"traj_stride": 1, "ref_leaves": tuple(
        (torch.rand(B, generator=gen, device="cuda", dtype=torch.float64) * 1.8 - 0.9).to(dtype) for _ in control)}
    if kind == "p":
        policy = P.AffinePolicy(PCL_P)
    elif kind in ("pi", "per_batch"):
        policy = P.AffinePolicy(PCL_P, Ki=PCL_KI, clip=1.0)
        loop["policy_carry"] = (torch.zeros(B, device="cuda", dtype=dtype),) * 2
    else:
        phys.omega_el = torch.full((B,), 1200.0, device="cuda", dtype=dtype)
        sensors = {"i_d": 3.0, "i_q": 3.0}
        if kind == "linear":
            policy, loop["policy_carry"] = P.make_pmsm_sensorless_current_tile(
                env, i_d_ref=-30.0, i_q_ref=60.0, omega_el=1200.0, measurement_std=sensors)
        else:
            policy, loop["policy_carry"], loop["sched_lut"] = P.make_pmsm_saturated_sensorless_current_tile(
                env, i_d_ref=-100.0, i_q_ref=150.0, omega_el=1200.0, measurement_std=sensors)
        scale = torch.tensor([6.0 / (pn.i_d.max - pn.i_d.min), 6.0 / (pn.i_q.max - pn.i_q.min)], device="cuda",
                             dtype=dtype)
        loop["obs_noise_tm"] = torch.randn((n_steps, B, 2), generator=gen, device="cuda", dtype=dtype) * scale
        loop["obs_noise_cols"] = (0, 1)
    state0 = (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
    return env, policy, state0, phys.omega_el, loop


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["p", "pi", "per_batch", "linear", "scheduled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pmsm_closed_loop_kernel_matches_plain_version(kind, dtype):
    _cuda()
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL

    n_steps = 32
    env, policy, state0, omega, loop = _pcl_case(kind, dtype, n_steps)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, **loop)
    before = PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"]
    outk = PCL.kernel_pmsm_closed_loop(env, state0, omega, policy, n_steps, **kw)
    outp = PCL.plain_pmsm_closed_loop(env, state0, omega, policy, n_steps, **kw)
    torch.cuda.synchronize()
    assert PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"] == before + 1
    flat = lambda out: [t for part in out if part is not None for t in part]
    assert len(flat(outk)) == len(flat(outp))
    for a, b in zip(flat(outk), flat(outp)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_pmsm_closed_loop_entry_points_launch_and_refuse():
    _cuda()
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL

    env = P.PMSM(batch_size=256, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"])
    _, state = env.vmap_reset(rng=torch.Generator(device="cuda").manual_seed(11))
    state.reference.i_d = torch.linspace(-200.0, -10.0, 256, device="cuda")
    state.reference.i_q = torch.linspace(-150.0, 150.0, 256, device="cuda")
    p_law = P.AffinePolicy(PCL_P)
    PCL.PMSM_CL_KERNEL.reset_counts()
    obs, last = env.fused_closed_loop(state, p_law, 8)
    batch, _ = P.RolloutCollector(env).collect_policy_fused(p_law, state, 8)
    assert PCL.PMSM_CL_KERNEL.launches == {"pmsm_closed_loop": 2}
    assert obs.is_cuda and obs.shape == (256, 10) and batch.rewards.shape == (256, 8, 1)
    assert bool(torch.isfinite(batch.observations).all())
    actor, ids = P.make_actor_tile(env)
    for policy, match in ((lambda obs, t: (-0.6 * obs[0], -0.6 * obs[1]), "plain callable"),
                          (actor, "built with")):
        with pytest.raises(ValueError, match=match):
            env.fused_closed_loop(state, policy, 8)
    phys = state.physical_state
    state0 = (phys.i_d.clone().requires_grad_(True), phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
    with pytest.raises(NotImplementedError, match="backward"):
        PCL.kernel_pmsm_closed_loop(env, state0, phys.omega_el, p_law, 8, tau=env.tau, solver=env._solver,
                                    props=env.env_properties, ref_leaves=(torch.zeros(256, device="cuda"),) * 2)
    assert PCL.PMSM_CL_KERNEL.launches == {"pmsm_closed_loop": 2}


FAST_CASES = [
    ("Pendulum", "euler", False),
    ("Pendulum", "rk4", False),
    ("Pendulum", "rk4", True),
    ("CartPole", "tsit5", False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,solver,sim_ahead", FAST_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fast_math_stepper_kernel_matches_plain_version(name, solver, sim_ahead, dtype):
    """fast_math=True: the FastMath functors and the fast wrap in csrc/stepper.cu."""
    _cuda()
    env = getattr(P, name)(batch_size=2048 + 45, solver=solver, fast_math=True, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(12)
    y0 = tuple((torch.rand(env.batch_size, generator=gen, device="cuda", dtype=torch.float64) * 8 - 4).to(dtype)
               for _ in env._ode_state_fields)
    acts = (torch.rand((32, env.batch_size, 1), generator=gen, device="cuda", dtype=torch.float64)
            * 1.8 - 0.9).to(dtype)
    kw = dict(tau=env.tau, obs_stride=4, sim_ahead=sim_ahead)
    yk, tk = K.kernel_rollout(env, y0, acts, **kw)
    yp, tp = K.plain_rollout(env, y0, acts, **kw)
    torch.cuda.synchronize()
    for a, b in zip(yk + tk, yp + tp):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fast_math_closed_loop_kernel_matches_plain_version(dtype):
    _cuda()
    env = P.Pendulum(batch_size=2048 + 45, control_state=["theta"], fast_math=True, dtype=dtype, solver="rk4")
    gen = torch.Generator(device="cuda").manual_seed(13)
    rand = lambda: (torch.rand(env.batch_size, generator=gen, device="cuda", dtype=torch.float64) * 6 - 3).to(dtype)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=(rand() / 3,), traj_stride=1)
    pd = P.AffinePolicy(PD_GAINS)
    y0 = (rand(), rand())
    outk = CL.kernel_closed_loop(env, y0, pd, 32, **kw)
    outp = CL.plain_closed_loop(env, y0, pd, 32, **kw)
    torch.cuda.synchronize()
    flat = lambda out: [t for part in out if part is not None for t in part]
    for a, b in zip(flat(outk), flat(outp)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,time_major", [(4096, False), (4096 - 5, True)])
def test_pendulum_fast_kernel_matches_plain_version(batch, time_major):
    _cuda()
    from exciting_environments_torch.ops.kernels import pendulum_fast as PFK

    env = P.Pendulum(batch_size=batch, tau=1e-4)
    _, state = env.vmap_reset(rng=torch.Generator(device="cuda").manual_seed(14))
    acts = torch.rand((batch, 64, 1), generator=torch.Generator(device="cuda").manual_seed(15), device="cuda") * 2 - 1
    if time_major:
        acts = acts.transpose(0, 1).contiguous()
    before = PFK.KERNEL.launches["pendulum_fast"]
    th, om = P.pendulum_fast_rollout(env, state, acts, time_major=time_major)
    assert PFK.KERNEL.launches["pendulum_fast"] == before + 1
    a_tm = acts[..., 0] if time_major else acts[..., 0].transpose(0, 1)
    th_p, om_p = PFK.plain_pendulum_fast_rollout(state.physical_state.theta, state.physical_state.omega, a_tm,
                                                 **PFK.fast_constants(env))
    torch.cuda.synchronize()
    assert torch.equal(th, th_p) and torch.equal(om, om_p)


PMSM_FAST_CASES = [
    ("DEFAULT", False, 0),
    ("DEFAULT", False, 1),
    ("BRUSA", True, 0),
    ("BRUSA", True, 1),
    ("SEW", True, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("variant,saturated,deadtime", PMSM_FAST_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pmsm_fast_kernel_matches_plain_version(variant, saturated, deadtime, dtype):
    _cuda()
    from exciting_environments_torch.ops import pmsm_fast as PF
    from exciting_environments_torch.ops.kernels import pmsm_fast_kernel as PFK

    params = dict(P.MotorVariant[variant].get_params().static_params.__dict__, deadtime=deadtime)
    if saturated:
        params.update(l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"))
    env = P.PMSM(batch_size=2048 + 45, saturated=saturated, motor_variant=P.MotorVariant[variant],
                 static_params=params, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(16)
    _, state = env.vmap_reset(rng=gen)
    acts = (torch.rand((env.batch_size, 32, 2), generator=gen, device="cuda", dtype=torch.float64) * 1.8 - 0.9).to(dtype)
    before = PFK.KERNEL.launches["pmsm_fast"]
    fast = env.fast_rollout(state, acts)
    assert PFK.KERNEL.launches["pmsm_fast"] == before + 1
    plain = PF.pmsm_fast_rollout(env, state, acts)
    torch.cuda.synchronize()
    for name in ("i_d", "i_q", "epsilon", "torque", "u_d_buffer", "u_q_buffer", "omega_el"):
        assert torch.equal(getattr(fast.physical_state, name), getattr(plain.physical_state, name)), name


@pytest.mark.gpu
def test_fast_kernels_refuse_and_a_failed_build_raises(tmp_path, monkeypatch):
    _cuda()
    from exciting_environments_torch.ops.kernels import pendulum_fast as PFK

    z = torch.zeros(256, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        PFK.kernel_pendulum_fast_rollout(z.double(), z.double(), torch.zeros((4, 256), device="cuda").double(),
                                         **PFK.fast_constants(P.Pendulum(batch_size=256)))
    with pytest.raises(NotImplementedError, match="backward"):
        PFK.kernel_pendulum_fast_rollout(z.clone().requires_grad_(True), z, torch.zeros((4, 256), device="cuda"),
                                         **PFK.fast_constants(P.Pendulum(batch_size=256)))
    env = P.PMSM(batch_size=256, saturated=True, motor_variant=P.MotorVariant.BRUSA, solver="rk4")
    _, state = env.vmap_reset()
    with pytest.raises(ValueError, match="Euler"):
        env.fast_rollout(state, torch.zeros((256, 4, 2), device="cuda"))
    # a source that does not compile: the build raises with nvcc's message
    (tmp_path / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(K, "CSRC", tmp_path)
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc failed to build broken.cu"):
        K.build_all(["broken"])
