"""The stepper, PMSM, closed-loop and PMSM closed-loop kernels (the PPO actor
in both closed loops), the fast-math
flag in the first and third, the PMSM kernel's process-noise slab, the five
later environments (VanDerPol, FluidTank, Acrobot, InductionMachine, EESM)
and the inverter circle in the stepper and closed-loop kernels, the
machines' drive-control tiles in the closed-loop kernel, and the fast
pendulum and fast PMSM kernels against their plain versions on a CUDA card;
and ``RolloutCollector.collect_fused`` through the stepper and PMSM kernels
against the eager ``collect`` on randomized fleets; the planners and
filters; ``fit_parameters`` through the stepper and PMSM kernels in
sim-ahead mode, ``ilqr_plan``, ``fisher_information`` and
``optimize_excitation`` against the CPU, and checkpoints, profiling and the
program's spans (one launch span per counted launch) on the card.

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


def _grad_deviation(fn_kernel, fn_plain, inputs, seed=0):
    """The largest deviation, over ``inputs``, of the gradients through the
    kernel's VJP (its launch, then the checkpointed replay) from autograd
    through the plain loop, each over the reference gradient's max abs; the
    loss weights every output with seeded weights."""
    def grads(fn):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        outs = [t for t in _nested(fn()) if t is not None]
        loss = sum((t * torch.rand(t.shape, generator=gen, device="cuda", dtype=t.dtype)).sum() for t in outs)
        return torch.autograd.grad(loss, inputs)

    worst = 0.0
    for a, b in zip(grads(fn_kernel), grads(fn_plain)):
        scale = float(b.abs().max())
        assert scale > 0
        worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def _nested(out):
    if out is None or isinstance(out, torch.Tensor):
        return [out]
    return [t for part in out for t in _nested(part)]


GRAD_LIMIT = {torch.float32: 1e-5, torch.float64: 1e-12}


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
    # an input that requires grad: the launch is the VJP's forward, and its
    # gradient agrees with autograd through the plain loop
    gen = torch.Generator(device="cuda").manual_seed(1)
    y0_g = tuple((torch.rand(256, generator=gen, device="cuda") * 2 - 1).requires_grad_(True) for _ in range(2))
    acts_g = (torch.rand((8, 256, 1), generator=gen, device="cuda") * 1.8 - 0.9).requires_grad_(True)
    before = K.KERNEL.launches["step"]
    dev = _grad_deviation(lambda: K.kernel_rollout(env, y0_g, acts_g, tau=env.tau, obs_stride=4),
                          lambda: K.plain_rollout(env, y0_g, acts_g, tau=env.tau, obs_stride=4), [*y0_g, acts_g])
    assert dev <= GRAD_LIMIT[torch.float32] and K.KERNEL.launches["step"] == before + 1
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eager_python_number_over_a_tensor_is_a_reciprocal_then_a_multiply(dtype):
    """``c / x`` on the card is ``x.reciprocal() * c`` (Tensor.__rtruediv__),
    the rule of eager_rules.cuh::rdiv that the inverter circle (``lim /
    clamp(mag, 1e-12)``) and the acrobot (``d_22 / d_12``) mirror: bit for
    bit, with the number rounded to the working type once."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.rand(1 << 16, generator=gen, device="cuda", dtype=torch.float64) * 500 + 1e-3).to(dtype)
    for c in (400.0 / 3 ** 0.5, 3.6, 1.0, 0.7):
        assert torch.equal(c / x, torch.reciprocal(x) * torch.tensor(c, dtype=dtype, device="cuda"))
        assert torch.equal(c / x, (1.0 / x) * c)


NEW_ENVS = {
    # name: (solvers, constructor arguments, per-batch parameter and its range)
    "VanDerPol": (("euler", "rk4"), {}, ("mu", 0.5, 20.0)),
    "FluidTank": (("euler", "heun"), {}, ("c_d", 0.4, 0.8)),
    "Acrobot": (("tsit5", "euler"), {}, ("m_2", 0.5, 1.5)),
    "InductionMachine": (("euler", "rk4"), {"u_dc": 400.0}, ("r_r", 1.8, 3.2)),
    "EESM": (("euler", "rk4"), {"u_dc": 400.0}, ("l_q", 3e-3, 6e-3)),
}


def _new_env(name, solver, dtype, batch, fast_math=False, **extra):
    _, kwargs, (field, lo, hi) = NEW_ENVS[name]
    cls = getattr(P, name)
    params = dict(cls._default_static_params())
    params[field] = torch.linspace(lo, hi, batch, dtype=torch.float64).numpy()
    return cls(batch_size=batch, solver=solver, dtype=dtype, static_params=params, fast_math=fast_math,
               **kwargs, **extra)


def _new_state(env, gen):
    lo, hi = (0.0, 3.0) if type(env).__name__ == "FluidTank" else (-2.0, 2.0)
    return tuple((torch.rand(env.batch_size, generator=gen, device="cuda", dtype=torch.float64) * (hi - lo) + lo)
                 .to(env.dtype) for _ in env._ode_state_fields)


NEW_CASES = [(n, s, m) for n, (solvers, _, _) in NEW_ENVS.items() for s in solvers for m in ("step", "sim_ahead")]


@pytest.mark.gpu
@pytest.mark.parametrize("name,solver,mode", NEW_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_new_environment_stepper_kernel_matches_plain_version(name, solver, mode, dtype):
    """Each new environment id in both modes, a per-batch parameter, the
    machines with u_dc and actions to 0.95 of the band (beyond the inverter
    circle on part of the fleet), a ragged B; 0.0 against the plain version."""
    _cuda()
    env = _new_env(name, solver, dtype, 4096 + 77)
    gen = torch.Generator(device="cuda").manual_seed(3)
    y0 = _new_state(env, gen)
    hold = 2 if mode == "sim_ahead" else 1
    acts = (torch.rand((32 // hold, env.batch_size, env.action_dim), generator=gen, device="cuda",
                       dtype=torch.float64) * 1.9 - 0.95).to(dtype)
    kw = dict(tau=env.tau, obs_stride=4, sim_ahead=mode == "sim_ahead", hold=hold)
    before = dict(K.KERNEL.launches)
    yk, tk = K.kernel_rollout(env, y0, acts, **kw)
    yk_bm, _ = K.kernel_rollout(env, y0, acts.transpose(0, 1).contiguous(), batch_major=True, **kw)
    yp, tp = K.plain_rollout(env, y0, acts, **kw)
    torch.cuda.synchronize()
    assert K.KERNEL.launches[mode] == before[mode] + 2
    for a, b in zip(yk + tk + yk_bm, yp + tp + yp):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_acrobot_fast_math_kernels_match_plain_version(dtype):
    _cuda()
    env = _new_env("Acrobot", "euler", dtype, 2048 + 3, fast_math=True, control_state=["theta_1"])
    gen = torch.Generator(device="cuda").manual_seed(4)
    y0 = _new_state(env, gen)
    acts = (torch.rand((32, env.batch_size, 1), generator=gen, device="cuda", dtype=torch.float64) * 1.8 - 0.9
            ).to(dtype)
    yk, tk = K.kernel_rollout(env, y0, acts, tau=env.tau, obs_stride=8)
    yp, tp = K.plain_rollout(env, y0, acts, tau=env.tau, obs_stride=8)
    refs = (torch.zeros(env.batch_size, device="cuda", dtype=dtype),)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs, traj_stride=4)
    pd = P.AffinePolicy([[-0.9, 0.0, -0.25, 0.0, 0.9]])
    outk = CL.kernel_closed_loop(env, y0, pd, 32, **kw)
    outp = CL.plain_closed_loop(env, y0, pd, 32, **kw)
    torch.cuda.synchronize()
    flat = lambda out: [t for part in out if part is not None for t in part]
    for a, b in zip(yk + tk + tuple(flat(outk)), yp + tp + tuple(flat(outp))):
        assert torch.equal(a, b)


NEW_CL = {
    # name: (solver, control field, gains over [state..., reference])
    "VanDerPol": ("rk4", "position", [[-0.8, -0.3, 0.8]]),
    "FluidTank": ("heun", "height", [[-0.9, 0.9]]),
    "Acrobot": ("tsit5", "theta_1", [[-0.9, 0.0, -0.25, 0.0, 0.9]]),
    "InductionMachine": ("rk4", "i_sd", [[-0.9, 0.0, 0.0, 0.0, 0.9], [0.0, -0.9, 0.0, 0.0, 0.0]]),
    "EESM": ("euler", "i_d", [[-0.9, 0.0, 0.0, 0.9], [0.0, -0.9, 0.0, 0.0], [0.0, 0.0, -0.5, 0.0]]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(NEW_CL))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_new_environment_closed_loop_kernel_matches_plain_version(name, dtype):
    """The affine law on each new environment (the machines with u_dc and a
    bias that drives part of the fleet beyond the inverter circle), saves
    every 4 steps, 0.0 against the plain version, one launch."""
    _cuda()
    solver, field, gains = NEW_CL[name]
    env = _new_env(name, solver, dtype, 2048 + 45, control_state=[field])
    gen = torch.Generator(device="cuda").manual_seed(5)
    y0 = _new_state(env, gen)
    refs = ((torch.rand(env.batch_size, generator=gen, device="cuda", dtype=torch.float64) * 2 - 1).to(dtype),)
    policy = P.AffinePolicy(gains, b=[0.6] * env.action_dim)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs, traj_stride=4)
    before = CL.CL_KERNEL.launches["closed_loop"]
    outk = CL.kernel_closed_loop(env, y0, policy, 32, **kw)
    outp = CL.plain_closed_loop(env, y0, policy, 32, **kw)
    torch.cuda.synchronize()
    assert CL.CL_KERNEL.launches["closed_loop"] == before + 1
    flat = lambda out: [t for part in out if part is not None for t in part]
    for a, b in zip(flat(outk), flat(outp)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_an_uncompiled_constraint_hook_raises_before_a_launch():
    """On CUDA tensors a constraint hook the kernels do not compute takes the
    loop on the open loop and raises before any launch on the closed loop."""
    _cuda()
    env = P.InductionMachine(batch_size=256, control_state=["i_sd"])
    env._constrain_action_tuple = lambda comps: (torch.clamp(comps[0], -100.0, 100.0), comps[1])
    _, state = env.vmap_reset()
    state.reference.i_sd = torch.zeros(256, device="cuda")
    acts = torch.zeros((256, 8, 2), device="cuda")
    K.KERNEL.reset_counts()
    CL.CL_KERNEL.reset_counts()
    assert not K.supports_fused_rollout(env)
    obs, _ = env.fused_rollout(state, acts)
    obs_l, _ = env.vmap_rollout(state, acts, 8)
    assert torch.equal(obs, obs_l[:, -1])
    with pytest.raises(ValueError, match="strict"):
        env.fused_rollout(state, acts, strict=True)
    with pytest.raises(ValueError, match="inverter circle"):
        env.fused_closed_loop(state, P.AffinePolicy(np.zeros((2, 5))), 8)
    assert K.KERNEL.launches == {"step": 0, "sim_ahead": 0} and CL.CL_KERNEL.launches == {"closed_loop": 0}


PMSM_CASES = [
    ("BRUSA", True, "euler", 1, False, None),
    ("SEW", True, "rk4", 1, False, 2),
    ("BRUSA", True, "tsit5", 0, False, None),
    ("DEFAULT", False, "euler", 1, False, 4),
    ("DEFAULT", False, "rk4", 0, True, 1),
    ("BRUSA", True, "rk4", 1, True, 1),
    ("BRUSA", True, "rk4", 0, True, 1),
    ("BRUSA", True, "euler", 0, False, 8),
]


def _pmsm_inputs(env, n_steps, seed):
    """(normalized time-major actions, state0, omega) of a reset drive."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _, state = env.vmap_reset(rng=gen)
    acts = ((torch.rand((n_steps, env.batch_size, 2), generator=gen, device="cuda", dtype=torch.float64)
             * 1.8 - 0.9).to(env.dtype))
    state0, omega = PK._start(state)
    return acts, state0, omega


def _flat(out):
    return [t for part in out if part is not None for t in part if t is not None]


@pytest.mark.gpu
@pytest.mark.parametrize("variant,saturated,solver,deadtime,sim_ahead,stride", PMSM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pmsm_kernel_matches_plain_version(variant, saturated, solver, deadtime, sim_ahead, stride, dtype):
    """The kernel takes the normalized actions and folds the angle, the
    constraint and the deadtime buffer in: every output equals the plain
    version's (the eager pre-pass, then the loop), both slab layouts."""
    _cuda()
    params = dict(P.MotorVariant[variant].get_params().static_params.__dict__, deadtime=deadtime)
    if saturated:
        params.update(l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"))
    env = P.PMSM(batch_size=2048 + 45, saturated=saturated, motor_variant=P.MotorVariant[variant],
                 solver=solver, static_params=params, dtype=dtype)
    acts, state0, omega = _pmsm_inputs(env, 32, 3)
    kw = dict(tau=env.tau, obs_stride=stride, sim_ahead=sim_ahead)
    mode = "pmsm_sim_ahead" if sim_ahead else "pmsm_step"
    before = PK.KERNEL.launches[mode]
    outk = PK.pmsm_kernel_rollout(env, acts, state0, omega, **kw)
    outp = PK.plain_pmsm_rollout(env, acts, state0, omega, **kw)
    outb = PK.pmsm_kernel_rollout(env, acts.transpose(0, 1).contiguous(), state0, omega, batch_major=True, **kw)
    torch.cuda.synchronize()
    assert PK.KERNEL.launches[mode] == before + 2
    assert len(_flat(outk)) == len(_flat(outp)) == len(_flat(outb))
    for a, b, c in zip(_flat(outk), _flat(outp), _flat(outb)):
        assert torch.equal(a, b) and torch.equal(c, b)


@pytest.mark.gpu
def test_pmsm_per_batch_parameters_match_plain_version():
    """Per-batch r_s, p and DC link, and a per-batch u_d action band."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    B = 1500
    uni = lambda lo, hi: lo + (hi - lo) * torch.rand(B, generator=gen, device="cuda")
    params = dict(P.MotorVariant.BRUSA.get_params().static_params.__dict__,
                  l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"), r_s=uni(15e-3, 21e-3), p=uni(2.0, 4.0),
                  u_dc=uni(350.0, 450.0))
    an = dict(P.MotorVariant.BRUSA.get_params().action_normalizations.__dict__)
    an["u_d"] = P.MinMaxNormalization(min=an["u_d"].min, max=uni(200.0, 300.0))
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, static_params=params,
                 action_normalizations=an)
    acts, state0, omega = _pmsm_inputs(env, 16, 5)
    for sim_ahead in (False, True):
        kw = dict(tau=env.tau, obs_stride=1, sim_ahead=sim_ahead)
        outk = PK.pmsm_kernel_rollout(env, acts, state0, omega, **kw)
        outp = PK.plain_pmsm_rollout(env, acts, state0, omega, **kw)
        for a, b in zip(_flat(outk), _flat(outp)):
            assert torch.equal(a, b)


PMSM_NOISE_CASES = [
    ("BRUSA", True, "euler", 0, None, (0, 1)),
    ("BRUSA", True, "rk4", 1, 4, (1,)),
    ("DEFAULT", False, "euler", 1, 2, (1, 0)),
    ("DEFAULT", False, "rk4", 0, 8, (0,)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("variant,saturated,solver,deadtime,stride,noise_idx", PMSM_NOISE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pmsm_noise_slab_matches_plain_version(variant, saturated, solver, deadtime, stride, noise_idx, dtype):
    """The process-noise slab of a stochastic drive: added to the currents
    after each step, before the save and the next gather, bit for bit with
    the plain loop in both slab layouts; the slab's cotangent follows
    autograd through the plain loop."""
    _cuda()
    params = dict(P.MotorVariant[variant].get_params().static_params.__dict__, deadtime=deadtime)
    if saturated:
        params.update(l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"))
    env = P.PMSM(batch_size=2048 + 45, saturated=saturated, motor_variant=P.MotorVariant[variant],
                 solver=solver, static_params=params, dtype=dtype)
    acts, state0, omega = _pmsm_inputs(env, 32, 9)
    gen = torch.Generator(device="cuda").manual_seed(10)
    noise = 0.5 * torch.randn((32, env.batch_size, len(noise_idx)), generator=gen, device="cuda", dtype=dtype)
    kw = dict(tau=env.tau, obs_stride=stride, noise_tm=noise, noise_idx=noise_idx)
    before = PK.KERNEL.launches["pmsm_step"]
    outk = PK.pmsm_kernel_rollout(env, acts, state0, omega, **kw)
    outp = PK.plain_pmsm_rollout(env, acts, state0, omega, **kw)
    outb = PK.pmsm_kernel_rollout(env, acts.transpose(0, 1).contiguous(), state0, omega, batch_major=True, **kw)
    quiet = PK.pmsm_kernel_rollout(env, acts, state0, omega, tau=env.tau, obs_stride=stride)
    torch.cuda.synchronize()
    assert PK.KERNEL.launches["pmsm_step"] == before + 3
    for a, b, c in zip(_flat(outk), _flat(outp), _flat(outb)):
        assert torch.equal(a, b) and torch.equal(c, b)
    assert not torch.equal(outk[0][noise_idx[0]], quiet[0][noise_idx[0]])
    with pytest.raises(ValueError, match="step-mode"):
        PK.pmsm_kernel_rollout(env, acts, state0, omega, sim_ahead=True, **kw)
    if dtype == torch.float64:
        acts = (acts * 0.5).requires_grad_(True)
        noise = noise.clone().requires_grad_(True)
        start = tuple(leaf.clone().requires_grad_(True) for leaf in state0)
        kw = dict(tau=env.tau, obs_stride=stride, noise_idx=noise_idx)
        dev = _grad_deviation(lambda: PK.pmsm_kernel_rollout(env, acts, start, omega, noise_tm=noise, **kw),
                              lambda: PK.plain_pmsm_rollout(env, acts, start, omega, noise_tm=noise, **kw),
                              [acts, noise, *start])
        assert dev <= GRAD_LIMIT[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("noise_mode", ["exact", "fast"])
def test_pmsm_stochastic_drive_is_one_launch(noise_mode):
    """A stochastic drive's fused rollout draws first and launches once; it
    equals the eager step loop from the same keys, keys included."""
    _cuda()
    from exciting_environments_torch.ops import random as R

    B = 1024
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA,
                 process_noise={"i_d": 2.0, "i_q": 2.0}, observation_noise={"i_d": 0.5, "i_q": 0.5, "torque": 0.2},
                 noise_mode=noise_mode, dtype=torch.float64)
    _, state = env.vmap_reset(R.split(R.PRNGKey(0), B))
    acts = 0.8 * torch.rand((B, 16, 2), generator=torch.Generator(device="cuda").manual_seed(1), device="cuda",
                            dtype=torch.float64) - 0.4
    PK.KERNEL.reset_counts()
    obs, last = env.fused_rollout(state, acts, obs_stride=4, strict=True)
    assert PK.KERNEL.launches["pmsm_step"] == 1
    obs_r, last_r = env.vmap_rollout(state, acts, obs_stride=4)
    assert torch.equal(last.PRNGKey, last_r.PRNGKey)
    torch.testing.assert_close(obs, obs_r, rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
def test_pmsm_refused_launch_raises():
    """A table too large for shared memory is refused at launch, and the
    wrapper raises instead of returning unwritten outputs."""
    _cuda()
    from exciting_environments_torch.ops.lut import StackedBilinearLUT

    env = P.PMSM(batch_size=256, saturated=True, motor_variant=P.MotorVariant.BRUSA, dtype=torch.float64)
    grid = np.linspace(-300.0, 300.0, 120)
    env._lut = StackedBilinearLUT(grid, grid, np.ones((6, 120, 120)), env._lut.channel_names,
                                  device="cuda", dtype=torch.float64)  # 921,600 B interleaved
    acts, state0, omega = _pmsm_inputs(env, 4, 6)
    with pytest.raises(RuntimeError, match="launch failed"):
        PK.pmsm_kernel_rollout(env, acts, state0, omega, tau=env.tau)
    # under autograd the launch is the VJP's forward: a refused launch raises
    # there too, and never falls back to the plain loop
    with pytest.raises(RuntimeError, match="launch failed"):
        PK.pmsm_kernel_rollout(env, acts.clone().requires_grad_(True), state0, omega, tau=env.tau)
    # with the drive's own table the gradient agrees with the plain loop's
    env = P.PMSM(batch_size=256, saturated=True, motor_variant=P.MotorVariant.BRUSA, dtype=torch.float64)
    acts, state0, omega = _pmsm_inputs(env, 8, 7)
    acts = (acts * 0.5).requires_grad_(True)
    state0 = tuple(leaf.clone().requires_grad_(True) for leaf in state0)
    kw = dict(tau=env.tau, obs_stride=4)
    dev = _grad_deviation(lambda: PK.pmsm_kernel_rollout(env, acts, state0, omega, **kw),
                          lambda: PK.plain_pmsm_rollout(env, acts, state0, omega, **kw), [acts, *state0])
    assert dev <= GRAD_LIMIT[torch.float64]


@pytest.mark.gpu
def test_pmsm_env_paths_run_on_the_card(monkeypatch):
    """One launch per entry-point call, and no eager pre-pass on the card."""
    _cuda()
    env = P.PMSM(batch_size=512, saturated=True, motor_variant=P.MotorVariant.BRUSA, solver="rk4")
    _, state = env.vmap_reset(rng=torch.Generator(device="cuda").manual_seed(7))
    acts = 0.3 * torch.ones((512, 8, 2), device="cuda")
    PK.KERNEL.reset_counts()
    prepass = []
    monkeypatch.setattr(PK, "_eps_trajectory", lambda *a: prepass.append("angle loop"))
    monkeypatch.setattr(P.PMSM, "_constrain", lambda *a: prepass.append("constraint"))
    obs, last = env.fused_rollout(state, acts, obs_stride=2, strict=True)
    obs_sa, _ = env.fused_sim_ahead(state, acts, env.tau, env.tau, strict=True)
    assert PK.KERNEL.launches == {"pmsm_step": 1, "pmsm_sim_ahead": 1} and prepass == []
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
    # inputs that require grad: each launch is the VJP's forward, and the
    # gradients in the state and in the gains agree with the plain loop's
    y0 = (state.physical_state.theta.clone().requires_grad_(True), state.physical_state.omega)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=(state.reference.theta,),
              traj_stride=2)
    dev = _grad_deviation(lambda: CL.kernel_closed_loop(env, y0, pd, 8, **kw),
                          lambda: CL.plain_closed_loop(env, y0, pd, 8, **kw), [y0[0]])
    assert dev <= GRAD_LIMIT[torch.float32]
    gains = pd.flat_params().float().cuda().requires_grad_(True)
    y0 = (state.physical_state.theta, state.physical_state.omega)
    zero = P.AffinePolicy(np.zeros((1, 3)))
    dev = _grad_deviation(lambda: CL.kernel_closed_loop(env, y0, zero, 8, policy_params=gains, **kw),
                          lambda: CL.plain_closed_loop(env, y0, zero, 8, policy_params=gains, **kw), [gains])
    assert dev <= GRAD_LIMIT[torch.float32]
    assert CL.CL_KERNEL.launches == {"closed_loop": 4}


def _machine_tile_case(kind, dtype, n_steps, batch=2048 + 45):
    """(env, policy, y0, loop kwargs) of one drive-control tile case: a
    random fleet whose first quarter starts cold (zero currents and flux,
    the fallback frame of the FOC law), saves every 4 steps; the sensorless
    tile on a sensor slab of 0.3 A, the EESM with u_dc = 400 and RK4."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    if kind == "eesm":
        env = P.EESM(batch_size=batch, dtype=dtype, solver="rk4", u_dc=400.0)
        policy, carry = P.make_eesm_current_tile(env, i_d_ref=2.0, i_q_ref=5.0, i_f_ref=4.0)
        lims = (8.0, 8.0, 8.0)
    else:
        noise = {"observation_noise": {"i_sd": 0.3, "i_sq": 0.3}} if kind == "sensorless" else {}
        env = P.InductionMachine(batch_size=batch, dtype=dtype, **noise)
        make = P.make_sensorless_foc_tile if kind == "sensorless" else P.make_foc_tile
        policy, carry = make(env, psi_ref=0.7, torque_ref=8.0)
        lims = (8.0, 8.0, 1.2, 1.2)
    cold = torch.arange(batch, device="cuda") < batch // 4
    y0 = tuple(torch.where(cold, 0.0, (torch.rand(batch, generator=gen, device="cuda", dtype=torch.float64) * 2 - 1)
                           * lim).to(dtype) for lim in lims)
    loop = dict(traj_stride=4, policy_carry=carry)
    if kind == "sensorless":
        loop["obs_noise_tm"] = 0.015 * torch.randn((n_steps, batch, 2), generator=gen, device="cuda", dtype=dtype)
        loop["obs_noise_cols"] = (0, 1)
    return env, policy, y0, loop


@pytest.mark.gpu
@pytest.mark.parametrize("kind,variant", [("foc", "foc"), ("sensorless", "sensorless_foc"),
                                          ("eesm", "eesm_current")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_machine_tile_kernel_matches_plain_version(kind, variant, dtype):
    """Each drive-control tile's functor in csrc/closed_loop.cu against the
    tile's forward in the plain loop: every output equal (0.0), one launch
    of its own instantiation."""
    _cuda()
    n_steps = 64
    env, policy, y0, loop = _machine_tile_case(kind, dtype, n_steps)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, **loop)
    before, before_v = CL.CL_KERNEL.launches["closed_loop"], CL.VARIANT_LAUNCHES[variant]
    outk = CL.kernel_closed_loop(env, y0, policy, n_steps, **kw)
    outp = CL.plain_closed_loop(env, y0, policy, n_steps, **kw)
    torch.cuda.synchronize()
    assert CL.CL_KERNEL.launches["closed_loop"] == before + 1 and CL.VARIANT_LAUNCHES[variant] == before_v + 1
    flat = lambda out: [t for part in out if part is not None for t in part]
    assert len(flat(outk)) == len(flat(outp))
    for a, b in zip(flat(outk), flat(outp)):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(t).all()) for t in flat(outk))


@pytest.mark.gpu
def test_machine_tiles_refuse_before_a_launch():
    """A tile built on a per-batch static parameter that the kernel folds
    (here l_m; a per-batch speed runs per drive), or a tile on another
    environment than its own, raises before any launch."""
    _cuda()
    params = dict(P.InductionMachine._default_static_params())
    params["l_m"] = torch.linspace(0.2, 0.225, 256, dtype=torch.float64).numpy()
    fleet = P.InductionMachine(batch_size=256, static_params=params)
    tile, carry = P.make_foc_tile(fleet, psi_ref=0.7, torque_ref=8.0)
    _, state = fleet.vmap_reset()
    before = dict(CL.CL_KERNEL.launches)
    with pytest.raises(ValueError, match="per-batch"):
        fleet.fused_closed_loop(state, tile, 8, policy_carry=carry)
    eesm = P.EESM(batch_size=256)
    e_tile, e_carry = P.make_eesm_current_tile(eesm, i_d_ref=2.0, i_q_ref=5.0, i_f_ref=4.0)
    im = P.InductionMachine(batch_size=256, control_state=["i_sd"])
    _, im_state = im.vmap_reset()
    with pytest.raises(ValueError, match="own machine"):
        CL.kernel_closed_loop(im, tuple(getattr(im_state.physical_state, n) for n in im._ode_state_fields),
                              e_tile, 8, tau=im.tau, solver=im._solver, props=im.env_properties,
                              ref_leaves=(im_state.physical_state.i_sd,), policy_carry=e_carry)
    assert CL.CL_KERNEL.launches == before


#: gym-electric-motor's default squirrel-cage machine
GEM_PARAMS = dict(r_s=2.9338, r_r=1.355, l_m=0.14375, l_s=0.14962, l_r=0.14962, p=2.0)


def _drive_fleet_case(kind, dtype, batch=2048 + 45):
    """(env, policy, y0, loop kwargs) of one per-drive tile case:
    gym-electric-motor's machine behind a 560 V DC link, each drive at its
    own speed over +-628.3 rad/s and torque setpoint over +-4.38 Nm (the
    sensorless tile with one filter per drive), a quarter starting cold (the
    fallback frame), saves every 4 steps."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    draw = lambda lim: ((torch.rand(batch, generator=gen, device="cuda", dtype=torch.float64) * 2 - 1) * lim)
    params = {**P.InductionMachine._default_static_params(), **GEM_PARAMS, "omega": draw(628.3).to(dtype)}
    env = P.InductionMachine(batch_size=batch, dtype=dtype, static_params=params, u_dc=560.0)
    law = dict(psi_ref=0.4, torque_ref=draw(4.38).to(dtype), i_max=5.5, kp_psi=40.0, ki_psi=800.0)
    if kind == "sensorless":
        policy, carry = P.make_sensorless_foc_tile(env, measurement_std={"i_sd": 0.055, "i_sq": 0.055}, **law)
    else:
        policy, carry = P.make_foc_tile(env, **law)
    cold = torch.arange(batch, device="cuda") < batch // 4
    y0 = tuple(torch.where(cold, 0.0, draw(lim)).to(dtype) for lim in (5.0, 5.0, 0.6, 0.6))
    return env, policy, y0, dict(traj_stride=4, policy_carry=carry)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,variant", [("foc", "foc_per_drive"), ("sensorless", "sensorless_foc_per_drive")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_per_drive_tile_kernel_matches_plain_version(kind, variant, dtype):
    """Each FOC tile on a fleet whose drives hold their own speed and torque
    setpoint (and observer gains): the per-drive functor of
    csrc/closed_loop.cu against the per-drive tile's forward in the plain
    loop on CUDA tensors, ragged B, every output equal (0.0), one launch of
    the per-drive instantiation reading the tile's planes."""
    _cuda()
    n_steps = 64
    env, policy, y0, loop = _drive_fleet_case(kind, dtype)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, **loop)
    spec = policy.kernel_spec(dtype, torch.device("cuda"))
    assert len(spec.planes) == len(policy.PLANES) and CL.kernel_variant(4, spec) == variant
    before, before_v = CL.CL_KERNEL.launches["closed_loop"], CL.VARIANT_LAUNCHES[variant]
    outk = CL.kernel_closed_loop(env, y0, policy, n_steps, **kw)
    outp = CL.plain_closed_loop(env, y0, policy, n_steps, **kw)
    torch.cuda.synchronize()
    assert CL.CL_KERNEL.launches["closed_loop"] == before + 1 and CL.VARIANT_LAUNCHES[variant] == before_v + 1
    flat = lambda out: [t for part in out if part is not None for t in part]
    assert len(flat(outk)) == len(flat(outp))
    for a, b in zip(flat(outk), flat(outp)):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(t).all()) for t in flat(outk))


@pytest.mark.gpu
def test_per_drive_fleet_runs_one_launch_a_chunk_and_packs_once():
    """FleetRunner.run_policy over a per-drive sensorless fleet through
    env_fused_closed_loop: one closed_loop launch of the per-drive
    instantiation a chunk, no gain solved and nothing packed again after the
    tile was built, and each chunk equal to the plain loop from the same
    state (0.0)."""
    from exciting_environments_torch.utils import foc
    from exciting_environments_torch.utils.fleet import FleetRunner

    _cuda()
    env, policy, y0, loop = _drive_fleet_case("sensorless", torch.float32)
    _, state = env.vmap_reset()
    state = P.core.structures.replace(state, physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, y0))))
    solves = dict(foc.GAIN_SOLVES)
    spec = policy.kernel_spec(torch.float32, torch.device("cuda"))
    runner = FleetRunner(env)
    before = CL.CL_KERNEL.launches["closed_loop"], CL.VARIANT_LAUNCHES["sensorless_foc_per_drive"]
    final, carry = runner.run_policy(state, policy, 3, 32, policy_carry=loop["policy_carry"])
    torch.cuda.synchronize()
    assert CL.CL_KERNEL.launches["closed_loop"] - before[0] == 3
    assert CL.VARIANT_LAUNCHES["sensorless_foc_per_drive"] - before[1] == 3
    assert foc.GAIN_SOLVES == solves and policy.kernel_spec(torch.float32, torch.device("cuda")) is spec
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties)
    y, c = y0, loop["policy_carry"]
    for _ in range(3):
        y, c, *_ = CL.plain_closed_loop(env, y, policy, 32, policy_carry=c, **kw)
    for a, b in zip(tuple(getattr(final.physical_state, n) for n in env._ode_state_fields) + tuple(carry), y + c):
        assert torch.equal(a, b)


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


#: observation noise columns of the pruned-law cases: none, columns the
#: pruned law reads (i_d, the q reference), columns it skips (torque, a
#: buffer), one of each
PRUNED_NOISE = {"none": (), "kept": (0, 9), "skipped": (3, 6), "both": (1, 5)}
PRUNED_CASES = [(law, solver, deadtime, stride, noise) for law in ("p", "pi") for solver in ("euler", "rk4")
                for deadtime in (0, 1) for stride in (None, 1) for noise in ("none", "kept", "skipped")]
PRUNED_CASES += [("pi", "euler", 1, 4, "both"), ("p", "rk4", 0, 2, "both")]


def _pruned_case(solver, deadtime, noise, n_steps, dtype=torch.float32):
    """(env, state0, omega, loop kwargs) of a saturated BRUSA fleet tracking
    current references, the linear inductances NaN (read by no saturated
    path); ragged B."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    B = 2048 + 45
    params = dict(P.MotorVariant.BRUSA.get_params().static_params.__dict__, deadtime=deadtime, l_d=float("nan"),
                  l_q=float("nan"), psi_p=float("nan"))
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, static_params=params,
                 dtype=dtype, solver=solver, control_state=["i_d", "i_q"])
    _, state = env.vmap_reset(rng=gen)
    phys = state.physical_state
    loop = {"ref_leaves": tuple((torch.rand(B, generator=gen, device="cuda", dtype=torch.float64) * 1.8 - 0.9).to(dtype)
                                for _ in range(2))}
    cols = PRUNED_NOISE[noise]
    if cols:
        loop["obs_noise_tm"] = 0.05 * torch.randn((n_steps, B, len(cols)), generator=gen, device="cuda", dtype=dtype)
        loop["obs_noise_cols"] = cols
    state0 = (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
    return env, state0, phys.omega_el, loop


def _pcl_equal_plain(env, policy, state0, omega, n_steps, variant, **loop):
    """One kernel launch against the plain version, every output under
    ``torch.equal``, and the instantiation it ran."""
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL

    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, **loop)
    if policy.n_carry:
        kw["policy_carry"] = tuple(torch.zeros(env.batch_size, device="cuda", dtype=env.dtype) for _ in range(2))
    before = dict(PCL.VARIANT_LAUNCHES)
    outk = PCL.kernel_pmsm_closed_loop(env, state0, omega, policy, n_steps, **kw)
    outp = PCL.plain_pmsm_closed_loop(env, state0, omega, policy, n_steps, **kw)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in PCL.VARIANT_LAUNCHES.items() if v != before[k]} == {variant: 1}
    flat = lambda out: [t for part in out if part is not None for t in part]
    assert len(flat(outk)) == len(flat(outp))
    for a, b in zip(flat(outk), flat(outp)):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(t).all()) for t in flat(outk))


@pytest.mark.gpu
@pytest.mark.parametrize("law,solver,deadtime,stride,noise", PRUNED_CASES)
def test_pruned_affine_law_matches_plain_version(law, solver, deadtime, stride, noise):
    """The P and PI laws on the currents and references take the pruned
    instantiation (no torque, cos/sin eps or buffer column built, the torque
    only for a save) and equal the plain version bit for bit: deadtime 0
    and 1, Euler and RK4, saves off, every step (the torque save included)
    and sparser, sensor noise on columns the law reads and on columns it
    skips."""
    _cuda()
    n_steps = 32
    env, state0, omega, loop = _pruned_case(solver, deadtime, noise, n_steps)
    policy = P.AffinePolicy(PCL_P, Ki=PCL_KI if law == "pi" else None)
    _pcl_equal_plain(env, policy, state0, omega, n_steps, "affine_currents", traj_stride=stride, **loop)


@pytest.mark.gpu
@pytest.mark.parametrize("matrix", ["K", "Ki"])
@pytest.mark.parametrize("col", [3, 4, 5, 6, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_gain_on_a_skipped_column_takes_the_full_law(matrix, col, dtype):
    """One nonzero gain on the torque, cos/sin eps or a buffer column (of K
    or of Ki) takes the instantiation that builds every column, and it
    equals the plain version bit for bit; so do the pruned law's own gains
    given at call time."""
    _cuda()
    n_steps = 32
    env, state0, omega, loop = _pruned_case("euler", 1, "skipped", n_steps, dtype)
    gains = {"K": [list(r) for r in PCL_P], "Ki": [list(r) for r in PCL_KI]}
    gains[matrix][1][col] = 0.05
    policy = P.AffinePolicy(gains["K"], Ki=gains["Ki"], clip=1.0)
    _pcl_equal_plain(env, policy, state0, omega, n_steps, "affine_all", traj_stride=1, **loop)
    if matrix == "K" and col == 3:
        pi = P.AffinePolicy(PCL_P, Ki=PCL_KI)
        params = pi.flat_params().to("cuda", dtype)
        _pcl_equal_plain(env, pi, state0, omega, n_steps, "affine_all", policy_params=params, **loop)


@pytest.mark.gpu
def test_a_pi_fleet_runs_the_pruned_law_every_chunk_and_chooses_it_once(monkeypatch):
    """FleetRunner.run_policy over n chunks of the PI law: n launches of the
    pruned instantiation, the choice made once (on the plan's miss), and
    the result equal to n chunks of the full law (the same gains given at
    call time), bit for bit."""
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
    from exciting_environments_torch.utils.fleet import FleetRunner

    _cuda()
    n = 5
    env, policy, state, carry, plans = _plan_fleet("pi", torch.float32)
    plans.clear()
    choose = PCL.kernel_variant
    chosen = []
    monkeypatch.setattr(PCL, "kernel_variant", lambda *a: chosen.append(1) or choose(*a))
    before = dict(PCL.VARIANT_LAUNCHES)
    final, final_c = FleetRunner(env).run_policy(state, policy, n, 32, policy_carry=carry)
    torch.cuda.synchronize()
    assert PCL.VARIANT_LAUNCHES["affine_currents"] - before["affine_currents"] == n and len(chosen) == 1
    assert PCL.VARIANT_LAUNCHES["affine_all"] == before["affine_all"]
    params = policy.flat_params().to("cuda", torch.float32)
    ref, ref_c = state, carry
    for _ in range(n):
        _, ref, ref_c = env.fused_closed_loop(ref, policy, 32, policy_carry=ref_c, policy_params=params)
    assert PCL.VARIANT_LAUNCHES["affine_all"] - before["affine_all"] == n
    _tree_equal((final, final_c), (ref, tuple(ref_c)))


def _plan_fleet(kind, dtype):
    """(env, policy, start state, carry, the wrapper's plan cache) of a fleet
    whose chunks run one closed-loop wrapper: the saturated BRUSA drive under
    the PI law (``kernel_pmsm_closed_loop``), or the per-drive sensorless FOC
    fleet (``kernel_closed_loop``); ragged B."""
    from exciting_environments_torch.core import structures
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL

    if kind == "foc":
        env, policy, y0, loop = _drive_fleet_case("sensorless", dtype)
        _, state = env.vmap_reset()
        state = structures.replace(state, physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, y0))))
        return env, policy, state, loop["policy_carry"], CL.PLANS
    B = 2048 + 45
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, dtype=dtype,
                 control_state=["i_d", "i_q"])
    _, state = env.vmap_reset(rng=torch.Generator(device="cuda").manual_seed(21))
    state.reference.i_d = torch.linspace(-200.0, -10.0, B, device="cuda", dtype=dtype)
    state.reference.i_q = torch.linspace(-150.0, 150.0, B, device="cuda", dtype=dtype)
    policy = P.AffinePolicy(PCL_P, Ki=PCL_KI)
    return env, policy, state, tuple(torch.zeros(B, device="cuda", dtype=dtype) for _ in range(2)), PCL.PLANS


def _uncached_chunks(env, policy, state, carry, plans, n, steps):
    """``n`` chunks of the entry point, each launched through the wrapper's
    full path (its plans dropped before every launch)."""
    for _ in range(n):
        plans.clear()
        _, state, carry = env.fused_closed_loop(state, policy, steps, policy_carry=carry)
    return state, tuple(carry)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pi", "foc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_plans_equal_uncached_launches_bit_for_bit(kind, dtype):
    """Four chunks of FleetRunner.run_policy, the last three through the
    launch plan the first one kept (``LAUNCH_PLANS``: 1 miss, 3 hits), equal
    four chunks each launched through the wrapper's full path, every state
    and carry leaf bit for bit."""
    from exciting_environments_torch.utils.fleet import FleetRunner

    _cuda()
    env, policy, state, carry, plans = _plan_fleet(kind, dtype)
    plans.clear()
    before = dict(plans.counts)
    final, final_c = FleetRunner(env).run_policy(state, policy, 4, 32, policy_carry=carry)
    torch.cuda.synchronize()
    assert plans.counts["hits"] - before["hits"] == 3 and plans.counts["misses"] - before["misses"] == 1
    before = dict(plans.counts)
    ref, ref_c = _uncached_chunks(env, policy, state, carry, plans, 4, 32)
    assert plans.counts["hits"] == before["hits"] and plans.counts["misses"] - before["misses"] == 4
    _tree_equal((final, final_c), (ref, ref_c))
    assert all(bool(torch.isfinite(t).all()) for t in final_c)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pi", "foc"])
def test_a_launch_plan_follows_a_policy_changed_between_chunks(kind):
    """A FOC setpoint plane written in place, or the PI law's gains written
    in place, between two chunks of one runner: the chunk after it packs
    the policy's spec again and misses the plan, and the result equals a
    fresh runner's over the same chunks (every launch through the full
    path), bit for bit."""
    from exciting_environments_torch.utils.fleet import FleetRunner

    _cuda()
    env, policy, state, carry, plans = _plan_fleet(kind, torch.float32)
    change = (lambda: policy.law.torque_ref.mul_(-0.5)) if kind == "foc" else (lambda: policy.K.mul_(0.5))
    undo = (lambda: policy.law.torque_ref.mul_(-2.0)) if kind == "foc" else (lambda: policy.K.mul_(2.0))
    plans.clear()
    before = dict(plans.counts)
    runner = FleetRunner(env)
    mid, mid_c = runner.run_policy(state, policy, 2, 32, policy_carry=carry)
    change()
    final, final_c = runner.run_policy(mid, policy, 2, 32, policy_carry=mid_c)
    torch.cuda.synchronize()
    assert plans.counts["hits"] - before["hits"] == 2 and plans.counts["misses"] - before["misses"] == 2
    undo()
    ref, ref_c = _uncached_chunks(env, policy, state, carry, plans, 2, 32)
    change()
    ref, ref_c = _uncached_chunks(env, policy, ref, ref_c, plans, 2, 32)
    _tree_equal((final, final_c), (ref, ref_c))


@pytest.mark.gpu
def test_a_launch_plan_leaves_grad_recording_to_the_vjp():
    """With a plan kept for the same static inputs, a call whose start
    leaves require grad still runs the checkpointed VJP, in both wrappers:
    its outputs carry the VJP's backward, and the gradient equals the one
    with no plan kept."""
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL

    _cuda()
    B, T = 256 + 3, 16
    drive = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"])
    _, st = drive.vmap_reset(rng=torch.Generator(device="cuda").manual_seed(22))
    phys = st.physical_state
    refs = (torch.full((B,), -0.5, device="cuda"), torch.zeros(B, device="cuda"))
    pi = P.AffinePolicy(PCL_P)
    pend = P.Pendulum(batch_size=B, control_state=["theta"])
    _, pst = pend.vmap_reset(rng=torch.Generator(device="cuda").manual_seed(23))
    pd = P.AffinePolicy(PD_GAINS)
    cases = [
        (PCL.PLANS, "PmsmClosedLoopVJP",
         lambda s0: PCL.kernel_pmsm_closed_loop(drive, s0, phys.omega_el, pi, T, tau=drive.tau, solver=drive._solver,
                                                props=drive.env_properties, ref_leaves=refs)[0],
         (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)),
        (CL.PLANS, "ClosedLoopVJP",
         lambda s0: CL.kernel_closed_loop(pend, s0, pd, T, tau=pend.tau, solver=pend._solver,
                                          props=pend.env_properties, ref_leaves=(torch.zeros(B, device="cuda"),))[0],
         tuple(getattr(pst.physical_state, n) for n in pend._ode_state_fields)),
    ]
    for plans, name, run, leaves in cases:
        grads = []
        for keep_plan in (False, True):
            plans.clear()
            if keep_plan:
                run(leaves)  # no leaf requires grad: the full path keeps a plan
                assert len(plans) == 1
            s0 = tuple(t.detach().clone().requires_grad_(True) for t in leaves)
            out = run(s0)
            assert out[0].grad_fn is not None and name in type(out[0].grad_fn).__name__
            grads.append(torch.autograd.grad(sum(o.sum() for o in out), s0))
        for a, b in zip(*grads):
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
    im = P.InductionMachine(batch_size=8)
    foc_tile = P.make_foc_tile(im, psi_ref=0.7, torque_ref=8.0)[0]
    for policy, match in ((lambda obs, t: (-0.6 * obs[0], -0.6 * obs[1]), "plain callable"),
                          (foc_tile, "built with")):
        with pytest.raises(ValueError, match=match):
            env.fused_closed_loop(state, policy, 8)
    # inputs that require grad: the launch is the VJP's forward, and the
    # gradients agree with autograd through the plain loop
    phys = state.physical_state
    state0 = (phys.i_d.clone().requires_grad_(True), phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
    gains = p_law.flat_params().float().cuda().requires_grad_(True)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, policy_params=gains, traj_stride=4,
              ref_leaves=(torch.zeros(256, device="cuda"),) * 2)
    dev = _grad_deviation(lambda: PCL.kernel_pmsm_closed_loop(env, state0, phys.omega_el, p_law, 8, **kw),
                          lambda: PCL.plain_pmsm_closed_loop(env, state0, phys.omega_el, p_law, 8, **kw),
                          [state0[0], gains])
    assert dev <= GRAD_LIMIT[torch.float32]
    assert PCL.PMSM_CL_KERNEL.launches == {"pmsm_closed_loop": 3}


PCL_ACTOR_CASES = [
    # (saturated, solver, hidden, deterministic, sensor slab)
    (True, "euler", (16, 16), False, False),
    (True, "euler", (16, 16), True, False),
    (True, "rk4", (16, 16), False, True),
    (False, "euler", (16, 16), False, False),
    (False, "rk4", (24, 8), False, True),
    (True, "euler", (24, 8), True, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("saturated,solver,hidden,deterministic,sensors", PCL_ACTOR_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pmsm_closed_loop_actor_matches_plain_version(saturated, solver, hidden, deterministic, sensors, dtype):
    """The PPO actor compiled into csrc/pmsm_closed_loop.cu (ActorReg<16, 16>
    and ActorLaw, family 1) against its plain version, bit for bit."""
    _cuda()
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
    from exciting_environments_torch.utils.convert import actor_params_from_numpy

    B, n_steps = 2048 + 37, 16
    gen = torch.Generator(device="cuda").manual_seed(31)
    variant = P.MotorVariant.BRUSA if saturated else P.MotorVariant.DEFAULT
    env = P.PMSM(batch_size=B, saturated=saturated, motor_variant=variant, control_state=["i_d", "i_q"],
                 solver=solver, dtype=dtype)
    _, state = env.vmap_reset(rng=gen)
    phys = state.physical_state
    rng = np.random.default_rng(5)
    sizes = (10, *hidden, 2)
    layers = [{"w": rng.normal(0.0, 1.0 / np.sqrt(m), (m, n)), "b": rng.normal(0.0, 0.1, n)}
              for m, n in zip(sizes[:-1], sizes[1:])]
    params = actor_params_from_numpy(env, {"actor": layers, "log_std": np.full(2, -1.0), "seed": 4321.0})
    policy, ids = P.make_actor_tile(env, deterministic=deterministic)
    loop = dict(traj_stride=1, policy_params=params, policy_carry=ids, ref_leaves=tuple(
        (torch.rand(B, generator=gen, device="cuda", dtype=torch.float64) * 1.8 - 0.9).to(dtype) for _ in range(2)))
    if sensors:
        loop.update(obs_noise_tm=0.05 * torch.randn((n_steps, B, 2), generator=gen, device="cuda", dtype=dtype),
                    obs_noise_cols=(0, 1))
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, **loop)
    state0 = (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
    before = PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"]
    outk = PCL.kernel_pmsm_closed_loop(env, state0, phys.omega_el, policy, n_steps, **kw)
    outp = PCL.plain_pmsm_closed_loop(env, state0, phys.omega_el, policy, n_steps, **kw)
    torch.cuda.synchronize()
    assert PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"] == before + 1
    flat = lambda out: [t for part in out if part is not None for t in part]
    assert len(flat(outk)) == len(flat(outp))
    for a, b in zip(flat(outk), flat(outp)):
        assert torch.equal(a, b)
    assert float(outk[3][5].abs().max()) <= 1.0  # the clamped actions


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


PENDULUM_FAST_CASES = [
    (4096, 64, False),
    (4096 - 5, 64, True),
    (4096 - 5, 64, False),  # ragged B, batch-major
    (1024, 4099, True),  # the horizon ends inside a ring tile
    (1024, 4099, False),  # batch-major rows no 16-byte multiple
    (1000, 4100, False),  # 16-byte rows, a ragged last tile and a ragged B
    (1000, 7, False),  # shorter than a tile
]


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n_steps,time_major", PENDULUM_FAST_CASES)
def test_pendulum_fast_kernel_matches_plain_version(batch, n_steps, time_major):
    """The fast pendulum's action ring in both layouts, read in place."""
    _cuda()
    from exciting_environments_torch.ops.kernels import pendulum_fast as PFK

    env = P.Pendulum(batch_size=batch, tau=1e-4)
    _, state = env.vmap_reset(rng=torch.Generator(device="cuda").manual_seed(14))
    gen = torch.Generator(device="cuda").manual_seed(15)
    acts = torch.rand((batch, n_steps, 1), generator=gen, device="cuda") * 2 - 1
    if time_major:
        acts = acts.transpose(0, 1).contiguous()
    assert PFK.kernel_slab(acts, time_major)[0].data_ptr() == acts.data_ptr()
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


def _pmsm_fast_case(dtype, deadtime, batch, leaves, seed):
    static = dict(P.MotorVariant.BRUSA.get_params().static_params.__dict__, deadtime=deadtime,
                  l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"))
    env = P.PMSM(batch_size=batch, saturated=True, motor_variant=P.MotorVariant.BRUSA, static_params=static,
                 dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _, state = env.vmap_reset(rng=gen)
    with P.core.structures.copy_and_mutate(state) as state:
        if leaves == "scalar":
            state.physical_state.omega_el = torch.tensor(1200.0, device="cuda", dtype=dtype)
            state.physical_state.epsilon = torch.tensor(-2.5, device="cuda", dtype=dtype)
        elif leaves == "wide":
            wide = torch.rand(batch, generator=gen, device="cuda", dtype=torch.float64) * 2e3 - 1e3
            state.physical_state.epsilon = wide.to(dtype)
    return env, state, gen


PMSM_FAST_LAYOUT_CASES = [
    # dtype, deadtime, B, T, time_major, leaves
    (torch.float32, 1, 2048 + 45, 32, True, None),
    (torch.float32, 0, 1000, 63, False, None),  # ragged B, odd T
    (torch.float64, 0, 2048, 32, True, None),  # the ~95 KB table, above 48 KB
    (torch.float64, 1, 1000, 33, False, None),
    (torch.float32, 1, 2048, 32, False, "scalar"),  # broadcast leaves, stride 0
    (torch.float32, 0, 2048, 32, True, "wide"),  # start angles beyond 2^7
    (torch.float64, 1, 2048, 32, False, "wide"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,deadtime,batch,n_steps,time_major,leaves", PMSM_FAST_LAYOUT_CASES)
def test_pmsm_fast_layouts_and_leaves_match_plain_version(dtype, deadtime, batch, n_steps, time_major, leaves):
    """The fast PMSM kernel, its start folded in, in both layouts read in place."""
    _cuda()
    from exciting_environments_torch.ops import pmsm_fast as PF
    from exciting_environments_torch.ops.kernels import pmsm_fast_kernel as PFK

    env, state, gen = _pmsm_fast_case(dtype, deadtime, batch, leaves, 17)
    shape = (n_steps, batch, 2) if time_major else (batch, n_steps, 2)
    acts = (torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64) * 1.8 - 0.9).to(dtype)
    assert PFK.kernel_slab(PF.fast_inputs(env, state, acts, time_major)[1])[0].data_ptr() == acts.data_ptr()
    before = PFK.KERNEL.launches["pmsm_fast"]
    fast = env.fast_rollout(state, acts, time_major=time_major)
    assert PFK.KERNEL.launches["pmsm_fast"] == before + 1
    plain = PF.pmsm_fast_rollout(env, state, acts, time_major=time_major)
    torch.cuda.synchronize()
    for name in ("i_d", "i_q", "epsilon", "torque", "u_d_buffer", "u_q_buffer", "omega_el"):
        assert torch.equal(getattr(fast.physical_state, name), getattr(plain.physical_state, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("time_major", [False, True])
def test_pmsm_fast_rollout_is_one_launch_and_no_eager_work(time_major, monkeypatch):
    """On the card PMSM.fast_rollout calls no eager start, final angle or
    Tensor.contiguous: the kernel computes them and reads the slab in place."""
    _cuda()
    from exciting_environments_torch.ops import pmsm_fast as PF
    from exciting_environments_torch.ops.kernels import pmsm_fast_kernel as PFK

    env, state, gen = _pmsm_fast_case(torch.float32, 1, 4096, None, 18)
    acts = torch.rand((16, 4096, 2) if time_major else (4096, 16, 2), generator=gen, device="cuda") * 0.6 - 0.3
    calls = []

    def refuse(name):
        def fn(*args, **kwargs):
            calls.append(name)
            raise AssertionError(f"{name} ran on the card")
        return fn

    for module in (PF, PFK):
        monkeypatch.setattr(module, "fast_start", refuse("fast_start"))
        monkeypatch.setattr(module, "fast_final_angle", refuse("fast_final_angle"))
    original = torch.Tensor.contiguous
    monkeypatch.setattr(torch.Tensor, "contiguous", lambda self, *a, **k: calls.append("contiguous") or
                        original(self, *a, **k))
    before = PFK.KERNEL.launches["pmsm_fast"]
    last = env.fast_rollout(state, acts, time_major=time_major)
    torch.cuda.synchronize()
    assert PFK.KERNEL.launches["pmsm_fast"] == before + 1 and calls == []
    assert bool(torch.isfinite(last.physical_state.i_d).all())


@pytest.mark.gpu
def test_pmsm_fast_start_trigonometry_matches_torch():
    """csrc/pmsm_fast.cu's start_sincos against torch.sin/cos, bit for bit:
    every float32 |x| < 2^8 and seeded float64 values."""
    _cuda()
    from exciting_environments_torch.ops.kernels import pmsm_fast_kernel as PFK

    end = int(np.array(2.0 ** 8, dtype=np.float32).view(np.int32))
    x = torch.arange(0, end, 61, dtype=torch.int32, device="cuda").view(torch.float32)
    for xs in (x, -x, (torch.rand(1 << 22, device="cuda", dtype=torch.float64) * 16 - 8),
               torch.tensor([0.0, -0.0, 1e3, -1e6, float("inf"), float("nan")], device="cuda", dtype=torch.float64)):
        counts = PFK.start_trig_mismatches(xs)
        assert counts["sin"] == 0 and counts["cos"] == 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, smem, blocks", [(torch.float32, 47_552, 4), (torch.float64, 95_104, 2)])
def test_pmsm_fast_shared_memory_and_occupancy(dtype, smem, blocks):
    """The fast PMSM kernel's dynamic shared memory for BRUSA, as
    csrc/pmsm_fast.cu sizes it and its source note states, and the blocks
    of 128 threads that share an SM."""
    _cuda()
    from exciting_environments_torch.ops.kernels import pmsm_fast_kernel as PFK

    env = P.PMSM(batch_size=128, saturated=True, motor_variant=P.MotorVariant.BRUSA, dtype=dtype)
    assert PFK.occupancy(env, dtype) == (blocks, smem)


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


@pytest.mark.gpu
def test_sincos_identities_hold_for_every_float32_below_2_7():
    """The PMSM closed loop's float32 sincos_pair against torch.sin/cos of x
    and -x, bit for bit, over every float32 |x| < 2^7."""
    _cuda()
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL

    counts = PCL.sincos_mismatches()
    assert counts.pop("inputs") == 2 * int(np.array(2.0 ** 7, dtype=np.float32).view(np.int32))
    assert counts == {"sin": 0, "cos": 0, "sin(-x)": 0, "cos(-x)": 0}


RING_CASES = [
    # (environment, solver, batch, action rows, hold, sim_ahead, batch_major, dtype)
    ("Pendulum", "euler", 4096, 64, 1, False, True, torch.float32),
    ("Pendulum", "rk4", 4096, 32, 2, True, True, torch.float32),  # use_next across tile boundaries
    ("Pendulum", "rk4", 4096, 32, 2, True, False, torch.float32),
    ("CartPole", "rk4", 4096, 50, 1, True, False, torch.float32),  # a horizon ending inside a tile
    ("CartPole", "tsit5", 1001, 50, 1, False, True, torch.float32),  # element-wise copies, ragged B
    ("Pendulum", "euler", 1001, 64, 1, False, False, torch.float32),
    ("MassSpringDamper", "rk4", 999, 21, 3, True, True, torch.float64),
    ("Pendulum", "rk4", 4096 + 77, 33, 1, True, False, torch.float64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,solver,batch,rows,hold,sim_ahead,batch_major,dtype", RING_CASES)
def test_stepper_action_ring_matches_plain_version(name, solver, batch, rows, hold, sim_ahead, batch_major, dtype):
    """The stepper's action ring in both slab layouts, with next rows across
    tile boundaries, horizons that end inside a tile and slabs whose rows
    are no 16-byte multiples, against the plain version bit for bit."""
    _cuda()
    env = getattr(P, name)(batch_size=batch, solver=solver, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(17)
    y0 = tuple((torch.rand(batch, generator=gen, device="cuda", dtype=torch.float64) * 4 - 2).to(dtype)
               for _ in env._ode_state_fields)
    acts = (torch.rand((rows, batch, 1), generator=gen, device="cuda", dtype=torch.float64) * 1.8 - 0.9).to(dtype)
    kw = dict(tau=env.tau, obs_stride=hold, sim_ahead=sim_ahead, hold=hold)
    slab = acts.transpose(0, 1).contiguous() if batch_major else acts
    yk, tk = K.kernel_rollout(env, y0, slab, batch_major=batch_major, **kw)
    yp, tp = K.plain_rollout(env, y0, acts, **kw)
    torch.cuda.synchronize()
    for a, b in zip(yk + tk, yp + tp):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_batch_major_fused_rollout_reads_the_slab_in_place():
    """env.fused_rollout on a batch-major slab at the main size (B = 65,536,
    T = 4,096, 1.07 GB) allocates less than the slab: no transposed copy."""
    _cuda()
    B, T = 65536, 4096
    env = P.Pendulum(batch_size=B, tau=1e-4)
    _, state = env.vmap_reset(rng=torch.Generator(device="cuda").manual_seed(18))
    acts = torch.rand((B, T, 1), generator=torch.Generator(device="cuda").manual_seed(19), device="cuda") * 2 - 1
    slab_bytes = acts.numel() * acts.element_size()
    obs_tm, _ = env.fused_rollout(state, acts.transpose(0, 1).contiguous(), time_major=True, strict=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    obs_bm, _ = env.fused_rollout(state, acts, strict=True)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < slab_bytes
    assert torch.equal(obs_tm, obs_bm)


@pytest.mark.gpu
def test_pmsm_sector_function_matches_torch():
    """The kernel's atan2f and the hexagon's sin sign bits against
    torch.atan2 and torch.sin, bit for bit, on seeded pairs and the sector
    edges."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(20)
    alpha, beta = ((torch.rand((2, 1 << 22), generator=gen, device="cuda") * 2 - 1) * 1.5).unbind(0)
    theta = torch.arange(-3, 4, device="cuda", dtype=torch.float64) * (np.pi / 3)
    edges_a, edges_b = torch.cos(theta).float(), torch.sin(theta).float()
    for a, b in ((alpha.contiguous(), beta.contiguous()), (edges_a, edges_b)):
        counts = PK.sector_mismatches(a, b)
        assert counts["atan2"] == 0 and counts["sector"] == 0


CL_VARIANT_CASES = [
    # (kind, hidden widths, the instantiation the wrapper picks)
    ("pd", None, "affine"),
    ("pi", None, "affine"),
    ("affine_two_refs", None, "affine_generic"),
    ("actor", (16, 16), "actor_16x16"),
    ("actor", (24, 8), "actor_generic"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,hidden,variant", CL_VARIANT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_closed_loop_instantiations_match_plain_version(kind, hidden, variant, dtype):
    """Each instantiation of csrc/closed_loop.cu (the register laws and the
    generic ones) against the plain version, and the launch counted under
    the instantiation the wrapper picked."""
    _cuda()
    n_steps = 32
    if kind == "affine_two_refs":
        env = P.Pendulum(batch_size=2048 + 45, control_state=["theta", "omega"], dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(21)
        rand = lambda: (torch.rand(env.batch_size, generator=gen, device="cuda", dtype=torch.float64) * 2
                        - 1).to(dtype)
        policy, y0, refs = P.AffinePolicy([[-0.9, -0.25, 0.9, 0.1]], clip=1.0), (rand(), rand()), (rand(), rand())
        loop = {"traj_stride": 1}
    else:
        env, policy, y0, refs, loop = _cl_case(kind, dtype, n_steps)
        if hidden is not None:
            loop["policy_params"] = _actor_params(env, hidden=hidden)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs, **loop)
    spec = policy.kernel_spec(dtype, "cuda", loop.get("policy_params"))
    assert CL.kernel_variant(len(y0), spec) == variant
    before = dict(CL.VARIANT_LAUNCHES)
    outk = CL.kernel_closed_loop(env, y0, policy, n_steps, **kw)
    outp = CL.plain_closed_loop(env, y0, policy, n_steps, **kw)
    torch.cuda.synchronize()
    assert CL.VARIANT_LAUNCHES[variant] == before[variant] + 1
    flat = lambda out: [t for part in out if part is not None for t in part]
    assert len(flat(outk)) == len(flat(outp))
    for a, b in zip(flat(outk), flat(outp)):
        assert torch.equal(a, b)


def _randomized_fleet(kind, dtype):
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.utils import randomize

    key = R.PRNGKey(3, "cuda")
    if kind == "pendulum":
        env = randomize.randomize_env(P.Pendulum, key, {"l": randomize.Uniform(0.5, 2.0)}, batch_size=4096 + 77,
                                      control_state=["theta"], dtype=dtype)
        state = env.vmap_reset(R.split(R.PRNGKey(1, "cuda"), env.batch_size))[1]
        state.reference.theta = torch.linspace(-1.5, 1.5, env.batch_size, device="cuda", dtype=dtype)
        n_action, lim = 1, 0.9
    else:
        defaults = dict(P.MotorVariant.BRUSA.get_params().static_params.__dict__)
        env = randomize.randomize_env(P.PMSM, key, {"r_s": randomize.Uniform(15e-3, 21e-3)}, batch_size=4096 + 77,
                                      defaults=defaults, saturated=True, motor_variant=P.MotorVariant.BRUSA,
                                      control_state=["i_d", "i_q"], dtype=dtype)
        state = env.vmap_reset(R.split(R.PRNGKey(1, "cuda"), env.batch_size))[1]
        state.reference.i_d = torch.linspace(-200.0, -10.0, env.batch_size, device="cuda", dtype=dtype)
        state.reference.i_q = torch.linspace(-150.0, 150.0, env.batch_size, device="cuda", dtype=dtype)
        n_action, lim = 2, 0.4
    from exciting_environments_torch.ops.signals import aprbs

    acts = aprbs(R.PRNGKey(2, "cuda"), env.batch_size, 24, n_action, hold_min=2, hold_max=9, minval=-lim,
                 maxval=lim, dtype=dtype)
    return env, state, acts


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pendulum", "brusa"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_collect_fused_equals_collect_on_a_randomized_fleet(kind, dtype):
    """One launch of the stepper (randomized pendulum lengths) or PMSM kernel
    (randomized BRUSA stator resistance) per call, and the batch and the
    final state of the eager collector, bit for bit."""
    _cuda()
    from exciting_environments_torch.ops.kernels import rollout_path
    from exciting_environments_torch.utils.collect import RolloutCollector

    env, state, acts = _randomized_fleet(kind, dtype)
    assert rollout_path(env) == ("fused" if kind == "pendulum" else "pmsm_fused")
    lib, mode = (K.KERNEL, "step") if kind == "pendulum" else (PK.KERNEL, "pmsm_step")
    col = RolloutCollector(env)
    before = lib.launches[mode]
    batch_f, final_f = col.collect_fused(state, acts)
    torch.cuda.synchronize()
    assert lib.launches[mode] == before + 1
    batch_s, final_s = col.collect(state, acts)
    assert lib.launches[mode] == before + 1
    for name in ("observations", "actions", "rewards", "terminated", "truncated"):
        a, b = getattr(batch_f, name), getattr(batch_s, name)
        assert a.shape == b.shape and torch.equal(a, b), name
    for name in env._ode_state_fields if kind == "pendulum" else ("i_d", "i_q", "epsilon", "torque", "u_d_buffer"):
        assert torch.equal(getattr(final_f.physical_state, name), getattr(final_s.physical_state, name)), name


@pytest.mark.gpu
def test_collect_fused_raises_when_the_kernel_fails(monkeypatch):
    """An in-scope environment on CUDA tensors never falls back to the eager
    collector: a kernel that cannot be built or launched raises."""
    _cuda()
    from exciting_environments_torch.utils.collect import RolloutCollector

    def fail():
        raise RuntimeError("the kernel library failed to build")

    def no_fallback(*args, **kwargs):
        raise AssertionError("collect_fused fell back to collect")

    for kind, lib in (("pendulum", K.KERNEL), ("brusa", PK.KERNEL)):
        env, state, acts = _randomized_fleet(kind, torch.float32)
        monkeypatch.setattr(lib, "lib", fail)
        monkeypatch.setattr(RolloutCollector, "collect", no_fallback)
        with pytest.raises(RuntimeError, match="failed to build"):
            RolloutCollector(env).collect_fused(state, acts)
        monkeypatch.undo()


COLLECTED = ("observations", "actions", "rewards", "terminated", "truncated")


def _epilogue_case(case, dtype, **overrides):
    """A BRUSA fleet for the collection's epilogue with keyed starts, drawn
    (i_d, i_q) references and an APRBS slab of 24 steps (23 for ``odd_t``),
    B = 4,173: ``ragged`` 1,000 drives (not a multiple of 128), ``deadtime0``,
    ``linear`` (unsaturated), ``batch_band`` (per-drive (B,) i_d and torque
    bands), ``process_noise`` (exact mode on i_q); ``overrides`` go to the
    constructor."""
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.ops.signals import aprbs
    from exciting_environments_torch.utils import MinMaxNormalization

    batch, steps = (1000 if case == "ragged" else 4096 + 77), (23 if case == "odd_t" else 24)
    brusa = P.MotorVariant.BRUSA.get_params()
    kw = dict(saturated=case != "linear", motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"])
    if case == "deadtime0":
        kw["static_params"] = {**vars(brusa.static_params), "deadtime": 0}
    if case == "batch_band":
        line = lambda lo, hi: torch.linspace(lo, hi, batch, device="cuda", dtype=dtype)
        norms = dict(vars(brusa.physical_normalizations))
        norms["i_d"] = MinMaxNormalization(min=line(-250.0, -220.0), max=0)
        norms["torque"] = MinMaxNormalization(min=-200, max=line(150.0, 250.0))
        kw["physical_normalizations"] = norms
    if case == "process_noise":
        kw["process_noise"] = {"i_q": 0.5}
    env = P.PMSM(batch_size=batch, dtype=dtype, **{**kw, **overrides})
    state = env.vmap_reset(R.split(R.PRNGKey(1, "cuda"), batch))[1]
    state.reference.i_d = torch.linspace(-200.0, -10.0, batch, device="cuda", dtype=dtype)
    state.reference.i_q = torch.linspace(-150.0, 150.0, batch, device="cuda", dtype=dtype)
    state.reference.torque = torch.linspace(-100.0, 100.0, batch, device="cuda", dtype=dtype)
    acts = aprbs(R.PRNGKey(2, "cuda"), batch, steps, 2, hold_min=2, hold_max=9, minval=-0.4, maxval=0.4, dtype=dtype)
    return env, state, acts


def _eager_rebuild(env, state, acts):
    """The collection as the eager path builds it: the kernel's saved states,
    then the observations, rewards and flags evaluated on them."""
    from exciting_environments_torch.utils.collect import RolloutCollector

    obs, traj_state, final = PK.pmsm_fused_rollout(env, state, acts, obs_stride=1, return_traj_states=True)
    return RolloutCollector(env)._assemble_batch(obs, acts, traj_state, final)


def _same_collection(got, want):
    """Two ``(TrajectoryBatch, final_state)`` equal bit for bit, with the same
    shapes, dtypes and strides."""
    for name in COLLECTED:
        a, b = getattr(got[0], name).detach(), getattr(want[0], name).detach()
        assert (a.shape, a.dtype, a.stride()) == (b.shape, b.dtype, b.stride()), name
        assert torch.equal(a, b), name
    for name in ("i_d", "i_q", "epsilon", "torque", "u_d_buffer", "u_q_buffer", "omega_el"):
        assert torch.equal(getattr(got[1].physical_state, name), getattr(want[1].physical_state, name)), name
    assert torch.equal(got[1].PRNGKey, want[1].PRNGKey)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged", "odd_t", "deadtime0", "linear", "batch_band", "process_noise"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_collect_epilogue_equals_the_eager_rebuild(case, dtype):
    """``collect_fused`` on a drive inside the epilogue's scope: one
    ``pmsm_step`` launch whose epilogue writes the observations, rewards and
    flags, counted under ``"epilogue"``, bit for bit with the eager rebuild
    from the saved states, in its shapes and strides."""
    _cuda()
    from exciting_environments_torch.utils.collect import RolloutCollector

    env, state, acts = _epilogue_case(case, dtype)
    assert PK.supports_collect_epilogue(env)
    paths, launches = dict(PK.COLLECT_PATHS), PK.KERNEL.launches["pmsm_step"]
    got = RolloutCollector(env).collect_fused(state, acts)
    torch.cuda.synchronize()
    assert PK.COLLECT_PATHS == {"epilogue": paths["epilogue"] + 1, "eager": paths["eager"]}
    assert PK.KERNEL.launches["pmsm_step"] == launches + 1
    _same_collection(got, _eager_rebuild(env, state, acts))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["torque_reward", "observation_noise", "grad"])
def test_collect_fused_outside_the_epilogue_takes_the_eager_rebuild(case):
    """Out of the epilogue's scope (a torque reward, observation noise, or an
    input that autograd records) ``collect_fused`` rebuilds from the saved
    states, counted under ``"eager"``, and still equals the eager path (the
    epilogue's result where only autograd differs)."""
    _cuda()
    from exciting_environments_torch.utils.collect import RolloutCollector

    kw = {"torque_reward": dict(control_state=["torque"]),
          "observation_noise": dict(observation_noise={"i_d": 0.01}), "grad": {}}[case]
    env, state, acts = _epilogue_case("ragged", torch.float32, **kw)
    col = RolloutCollector(env)
    want = _eager_rebuild(env, state, acts) if case != "grad" else col.collect_fused(state, acts)
    assert PK.supports_collect_epilogue(env) == (case == "grad")
    paths, launches = dict(PK.COLLECT_PATHS), PK.KERNEL.launches["pmsm_step"]
    if case == "grad":
        acts = acts.clone().requires_grad_(True)
    with torch.enable_grad():
        got = col.collect_fused(state, acts)
    torch.cuda.synchronize()
    assert PK.COLLECT_PATHS == {"epilogue": paths["epilogue"], "eager": paths["eager"] + 1}
    assert PK.KERNEL.launches["pmsm_step"] == launches + 1
    assert got[0].observations.requires_grad == (case == "grad")
    _same_collection(got, want)


def _planning_case(kind, dtype, batch=64):
    """A tracking Pendulum or a saturated BRUSA drive on the card with drawn
    references, the kernel library that plans it, and its launch mode."""
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.utils.episodes import reset_with_references

    if kind == "pendulum":
        env = P.Pendulum(batch_size=batch, tau=2e-2, control_state=["theta"], dtype=dtype)
        lib, mode = K.KERNEL, "step"
    else:
        env = P.PMSM(batch_size=batch, saturated=True, motor_variant=P.MotorVariant.BRUSA,
                     control_state=["i_d", "i_q"], dtype=dtype)
        lib, mode = PK.KERNEL, "pmsm_step"
    _, state = reset_with_references(env, R.PRNGKey(7, "cuda"))
    return env, state, lib, mode


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pendulum", "brusa"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_plan_equals_the_scan_plan_one_launch_per_iteration(kind, dtype):
    """MPPI's fused backend folds the samples into one kernel rollout per
    iteration (``fused=True``) and plans what the eager scan plans, bit for
    bit; the scan launches nothing."""
    _cuda()
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.utils import mpc

    env, state, lib, mode = _planning_case(kind, dtype)
    cfg = mpc.MPPIConfig(horizon=8, n_samples=32, n_iterations=2, smoothing=0.5)
    lib.reset_counts()
    fused = mpc.run_mppi(env, state, 3, R.PRNGKey(1, "cuda"), cfg, fused=True)
    torch.cuda.synchronize()
    assert lib.launches[mode] == 3 * cfg.n_iterations and sum(lib.launches.values()) == lib.launches[mode]
    lib.reset_counts()
    scan = mpc.run_mppi(env, state, 3, R.PRNGKey(1, "cuda"), cfg, fused=False)
    torch.cuda.synchronize()
    assert sum(lib.launches.values()) == 0
    for name in ("observations", "actions", "rewards", "plan"):
        assert torch.equal(getattr(fused, name), getattr(scan, name)), name
    assert fused.plan.device.type == "cuda" and fused.plan.dtype == dtype


@pytest.mark.gpu
def test_fused_plan_refuses_out_of_scope_before_a_launch():
    _cuda()
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.utils import mpc

    env = P.Pendulum(batch_size=64, tau=2e-2, control_state=["theta"], solver="implicit_euler")
    _, state = env.vmap_reset(R.split(R.PRNGKey(0, "cuda"), 64))
    state.reference.theta = torch.zeros(64, device="cuda")
    K.KERNEL.reset_counts()
    with pytest.raises(ValueError, match="fused=True"):
        mpc.run_mppi(env, state, 2, config=mpc.MPPIConfig(horizon=4, n_samples=8), fused=True)
    assert sum(K.KERNEL.launches.values()) == 0


@pytest.mark.gpu
def test_filters_run_on_the_card_like_the_cpu():
    """``run_ekf`` and ``run_ukf`` keep the environment's device: a float64
    card run agrees with the CPU's on the same log to 1e-10 of each leaf's
    scale."""
    _cuda()
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.utils import estimate

    make = lambda device: P.Pendulum(batch_size=16, tau=2e-2, observation_noise={"theta": 0.08}, device=device,
                                     dtype=torch.float64)
    card = make("cuda")
    _, st = card.vmap_reset(R.split(R.PRNGKey(7, "cuda"), 16))
    acts = (0.3 * torch.sin(torch.arange(64, dtype=torch.float64) * 0.04))[None, :, None].expand(16, 64, 1)
    obs = card.vmap_rollout(st, acts.cuda())[0]
    kw = dict(measured_fields=("theta",), process_std={"omega": 0.05})
    for run in (lambda env, o, a: estimate.run_ekf(env, o, a, smooth=True, **kw),
                lambda env, o, a: estimate.run_ukf(env, o, a, **kw)):
        on_card = run(card, obs, acts.cuda())
        on_cpu = run(make("cpu"), obs.cpu(), acts)
        assert on_card.means.device.type == "cuda"
        for name in ("means", "covs", "nll"):
            x, y = getattr(on_card, name).cpu(), getattr(on_cpu, name)
            assert float((x - y).abs().max()) <= 1e-10 * float(y.abs().max()), name


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pendulum", "pmsm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fit_parameters_runs_one_kernel_launch_per_iteration(kind, dtype):
    """``fit_parameters`` through the stepper (Pendulum) or PMSM kernel in
    sim-ahead mode: one launch per iteration and one for the final check,
    the first gradient equal to eager autograd through ``vmap_sim_ahead``
    within GRAD_LIMIT, and the same loss curve as the CPU within the type's
    rounding."""
    _cuda()
    from exciting_environments_torch.core import structures
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.ops.signals import aprbs
    from exciting_environments_torch.utils import sysid

    if kind == "pendulum":
        env, lib, mode = P.Pendulum(batch_size=1, tau=1e-2, dtype=dtype), K, "sim_ahead"
        true, guess, n, seg, a_dim = {"l": 1.3, "m": 0.8}, {"l": 1.0, "m": 1.0}, 64, 16, 1
    else:
        env, lib, mode = P.PMSM(batch_size=1, dtype=dtype), PK, "pmsm_sim_ahead"
        sp = env.env_properties.static_params
        true = {"r_s": float(sp.r_s) * 1.4, "l_d": float(sp.l_d) * 0.75, "l_q": float(sp.l_q) * 1.2}
        guess, n, seg, a_dim = {k: float(getattr(sp, k)) for k in true}, 64, 16, 2
    props = structures.replace(env.env_properties, static_params=structures.replace(env.env_properties.static_params,
                                                                                    **true))
    actions = aprbs(R.PRNGKey(0, "cuda"), 1, n, a_dim, hold_min=3, hold_max=12, dtype=dtype)[0]
    recorded, _, _ = env.sim_ahead(env.init_state(props), actions, props, env.tau, env.tau)
    lib.KERNEL.reset_counts()
    res = sysid.fit_parameters(env, actions, recorded, guess, n_starts=16, iterations=6, segment_length=seg)
    assert lib.KERNEL.launches[mode] == 7 and sum(lib.KERNEL.launches.values()) == 7
    assert bool(torch.isfinite(res.losses).all()) and float(res.losses[-1]) < float(res.losses[0])
    theta0, _, losses = sysid._fit_problem(env, actions, recorded, guess, None, env.tau, env.tau, 16, 0.3, None,
                                           "log", seg, R.PRNGKey(0, "cuda"))
    grads = []
    for eager in (False, True):
        theta = theta0.detach().requires_grad_(True)
        grads.append(torch.autograd.grad(losses(theta, eager=eager).sum(), theta)[0])
    assert float((grads[0] - grads[1]).abs().max()) <= GRAD_LIMIT[dtype] * float(grads[1].abs().max())
    cpu_env = (P.Pendulum(batch_size=1, tau=1e-2, device="cpu", dtype=dtype) if kind == "pendulum"
               else P.PMSM(batch_size=1, device="cpu", dtype=dtype))
    ref = sysid.fit_parameters(cpu_env, actions.cpu(), recorded.cpu(), guess, n_starts=16, iterations=6,
                               segment_length=seg, key=R.PRNGKey(0, "cpu"))
    scale = float(ref.losses.abs().max())
    assert float((res.losses.cpu() - ref.losses).abs().max()) <= (1e-3 if dtype == torch.float32 else 1e-10) * scale


@pytest.mark.gpu
def test_ilqr_fisher_and_excitation_run_on_the_card():
    """``ilqr_plan``, ``fisher_information`` (one stepper launch) and
    ``optimize_excitation`` on CUDA tensors against the CPU in float64."""
    _cuda()
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.utils import ilqr, sysid
    from exciting_environments_torch.utils.episodes import reset_with_references

    out = {}
    for device in ("cuda", "cpu"):
        env = P.Pendulum(batch_size=8, tau=2e-2, control_state=["theta"], device=device, dtype=torch.float64)
        _, state = reset_with_references(env, R.PRNGKey(1, device))
        K.KERNEL.reset_counts()
        plan = ilqr.ilqr_plan(env, state, torch.zeros((8, 16, 1), dtype=torch.float64, device=device), iterations=4)
        assert sum(K.KERNEL.launches.values()) == 0
        single = P.Pendulum(batch_size=1, tau=1e-2, device=device, dtype=torch.float64)
        acts = 0.5 * torch.sin(torch.arange(64, dtype=torch.float64, device=device) / 5.0)[:, None]
        fim = sysid.fisher_information(single, acts, ("l", "m"))
        assert K.KERNEL.launches["sim_ahead"] == (1 if device == "cuda" else 0)
        exc = sysid.optimize_excitation(single, ("l", "m"), 24, iterations=5)
        out[device] = (plan.costs, plan.actions, fim.fim, exc.objectives)
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a.cpu() - b).abs().max()) <= 1e-9 * float(b.abs().max())


@pytest.mark.gpu
def test_checkpoint_and_profiling_on_the_card(tmp_path):
    """A state saved from the card loads onto the card and onto the CPU;
    the profiler's trace holds device activity; the timer fences the card."""
    _cuda()
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.utils import checkpoint, profiling

    env = P.Pendulum(batch_size=64)
    _, state = env.vmap_reset(R.split(R.PRNGKey(0, "cuda"), 64))
    _, state = env.vmap_step(state, 0.3 * torch.ones((64, 1), device="cuda"))
    path = checkpoint.save_state(state, str(tmp_path / "s"))
    back = checkpoint.load_state(env.vmap_init_state(R.split(R.PRNGKey(1, "cuda"), 64)), path)
    assert back.physical_state.theta.device.type == "cuda"
    assert torch.equal(back.physical_state.theta, state.physical_state.theta)
    assert torch.equal(back.PRNGKey, state.PRNGKey)
    cpu = P.Pendulum(batch_size=64, device="cpu")
    on_cpu = checkpoint.load_state(cpu.vmap_init_state(R.split(R.PRNGKey(1, "cpu"), 64)), path)
    assert torch.equal(on_cpu.physical_state.theta, state.physical_state.theta.cpu())
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("steps"):
            env.fused_rollout(state, torch.zeros((64, 32, 1), device="cuda"))
    assert len(list((tmp_path / "trace").iterdir())) == 1
    timer = profiling.Timer()
    with timer.measure() as m:
        m.block(env.fused_rollout(state, torch.zeros((64, 256, 1), device="cuda")))
    assert timer.best > 0


def _tree_equal(a, b):
    from exciting_environments_torch.core import structures

    la, lb = structures.leaves(a), structures.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.shape == y.shape and x.dtype == y.dtype
            assert torch.equal(x.nan_to_num(7.0) if x.is_floating_point() else x,
                               y.nan_to_num(7.0) if y.is_floating_point() else y)
        else:
            assert x == y or (x != x and y != y)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_env_runs_kernels_1_to_4_per_shard_at_zero(dtype):
    """``ShardedEnv`` over ``["cuda:0"] * 4``: the open-loop stepper and PMSM
    kernels (per-drive ``r_s``), and the closed-loop and PMSM closed-loop
    kernels (the PI law with a per-drive ``u_dc``), one launch per shard,
    each split call equal to the unsplit call at 0.0 in every leaf."""
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
    from exciting_environments_torch.parallel import ShardedEnv, make_batch_mesh

    _cuda()
    mesh = make_batch_mesh(["cuda:0"] * 4)
    B, T = 4096 + 4 * 19, 32
    gen = torch.Generator(device="cuda").manual_seed(3)
    env = P.Pendulum(batch_size=B, dtype=dtype, static_params={"g": 9.81, "m": 1.0,
                                                               "l": 1 + torch.rand(B, generator=gen, device="cuda")})
    _, s = env.vmap_reset(rng=gen)
    a = (torch.rand(B, T, 1, generator=gen, device="cuda") * 1.8 - 0.9).to(dtype)
    senv = ShardedEnv(env, mesh)
    K.KERNEL.reset_counts()
    split = senv.fused_rollout(s, a, obs_stride=4, strict=True)
    assert K.KERNEL.launches["step"] == 4
    _tree_equal(split, env.fused_rollout(s, a, obs_stride=4, strict=True))
    _tree_equal(senv.fused_rollout(s, a.transpose(0, 1), time_major=True, strict=True),
                env.fused_rollout(s, a, strict=True))

    var = P.MotorVariant.BRUSA
    params = dict(var.get_params().static_params.__dict__, l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"),
                  r_s=0.015 + 0.006 * torch.rand(B, generator=gen, device="cuda"),
                  u_dc=350.0 + 100.0 * torch.rand(B, generator=gen, device="cuda"))
    drive = P.PMSM(batch_size=B, saturated=True, motor_variant=var, static_params=params, dtype=dtype,
                   control_state=["i_d", "i_q"])
    _, ds = drive.vmap_reset(rng=gen)
    ds.reference.i_d = torch.linspace(-200.0, -10.0, B, device="cuda", dtype=dtype)
    ds.reference.i_q = torch.linspace(-150.0, 150.0, B, device="cuda", dtype=dtype)
    v = (torch.rand(B, T, 2, generator=gen, device="cuda") * 0.6 - 0.3).to(dtype)
    sdrive = ShardedEnv(drive, mesh)
    PK.KERNEL.reset_counts()
    split = sdrive.fused_rollout(ds, v, strict=True)
    assert PK.KERNEL.launches["pmsm_step"] == 4
    _tree_equal(split, drive.fused_rollout(ds, v, strict=True))

    tracking = P.Pendulum(batch_size=B, dtype=dtype, control_state=["theta"])
    _, ts = tracking.vmap_reset(rng=gen)
    ts.reference.theta = torch.linspace(-1.5, 1.5, B, device="cuda", dtype=dtype)
    pi = P.AffinePolicy([[-0.9, -0.25, 0.9]], Ki=[[-2e-3, 0.0, 2e-3]], clip=1.0)
    c0 = (torch.zeros(B, device="cuda", dtype=dtype),)
    CL.CL_KERNEL.reset_counts()
    split = ShardedEnv(tracking, mesh).fused_closed_loop(ts, pi, T, obs_stride=1, policy_carry=c0)
    assert CL.CL_KERNEL.launches["closed_loop"] == 4
    _tree_equal(split, tracking.fused_closed_loop(ts, pi, T, obs_stride=1, policy_carry=c0))

    p_law = [[-0.6, 0, 0, 0, 0, 0, 0, 0, 0.6, 0], [0, -0.6, 0, 0, 0, 0, 0, 0, 0, 0.6]]
    ki = [[-0.01, 0, 0, 0, 0, 0, 0, 0, 0.01, 0], [0, -0.01, 0, 0, 0, 0, 0, 0, 0, 0.01]]
    dpi = P.AffinePolicy(p_law, Ki=ki)
    dc0 = tuple(torch.zeros(B, device="cuda", dtype=dtype) for _ in range(2))
    PCL.PMSM_CL_KERNEL.reset_counts()
    split = sdrive.fused_closed_loop(ds, dpi, T, policy_carry=dc0)
    assert PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"] == 4
    _tree_equal(split, drive.fused_closed_loop(ds, dpi, T, policy_carry=dc0))


@pytest.mark.gpu
def test_gym_wrapper_and_autoreset_step_on_the_card_follow_the_cpu():
    """``GymWrapper`` (references on) and the vector step with autoreset on
    the card against the same runs on the CPU, float64: hold steps, keys and
    flags equal, observations and rewards within 1e-12 (CUDA's and the
    CPU's ``sin`` may differ in the last bit)."""
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.utils import episodes

    _cuda()
    B = 256
    out = {}
    for device in ("cpu", "cuda"):
        env = P.Pendulum(batch_size=B, control_state=["theta"], device=device, dtype=torch.float64)
        gw = P.GymWrapper(env=env, control_state=["theta"], ref_params={"hold_steps_min": 2, "hold_steps_max": 9})
        gw.reset(rng_env=R.split(R.PRNGKey(0, device), B), rng_ref=R.PRNGKey(1, device))
        rows = []
        for t in range(30):
            a = torch.full((B, 1), 0.3 * (-1) ** t, dtype=torch.float64, device=device)
            rows.append([x.cpu() for x in gw.step(a)] + [gw.reference_hold_steps.cpu()])
        _, state = episodes.reset_with_references(env, R.PRNGKey(2, device))
        mask = torch.zeros(B, dtype=torch.bool, device=device)
        elapsed = torch.zeros(B, dtype=torch.int32, device=device)
        any_reset = False
        for t, k in enumerate(R.split(R.PRNGKey(3, device), 30)):
            a = torch.full((B, 1), 0.5, dtype=torch.float64, device=device)
            o, r, te, tr, state, mask, elapsed = episodes._autoreset_step(env, state, mask, any_reset, elapsed, a, k, 7)
            any_reset = bool(mask.any())
            rows.append([o.cpu(), r.cpu(), te.cpu(), tr.cpu(), elapsed.cpu(), state.PRNGKey.cpu()])
        out[device] = rows
    for cpu_row, card_row in zip(out["cpu"], out["cuda"]):
        for x, y in zip(cpu_row, card_row):
            if x.is_floating_point():
                np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-12, atol=1e-12)
            else:
                assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fleet_runner_kernel_paths_match_direct_calls(dtype, tmp_path):
    """``FleetRunner`` on the card: the open loop through kernels 1 and 3 and
    the closed loops through kernels 2 and 4 (the PD law, the stateful PI
    law), one launch per chunk (four when split over ``["cuda:0"] * 4``),
    each final state 0.0 from the same chunks driven directly through the
    entry points; a plain callable on the in-scope environment raises before
    a launch; a native shard written on the way reads back byte for byte."""
    from exciting_environments_torch.io import ShardIndex, ShardWriter
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
    from exciting_environments_torch.parallel import ShardedEnv, make_batch_mesh
    from exciting_environments_torch.utils.fleet import FleetRunner

    _cuda()
    B, T, n = 4096 + 4 * 19, 32, 3
    gen = torch.Generator(device="cuda").manual_seed(11)
    env = P.Pendulum(batch_size=B, dtype=dtype)
    _, s0 = env.vmap_reset(rng=gen)
    slabs = [(torch.rand(B, T, 1, generator=gen, device="cuda") * 1.8 - 0.9).to(dtype) for _ in range(n)]
    with ShardWriter(tmp_path / "f.extpu") as w:
        assert w.native
        runner = FleetRunner(env, writer=w, write_actions=True)
        assert runner.rollout_path == "fused"
        K.KERNEL.reset_counts()
        final = runner.run(s0, lambda k: slabs[k], n, T)
        assert K.KERNEL.launches["step"] == n
    direct = s0
    for k in range(n):
        obs, direct = env.fused_rollout(direct, slabs[k], strict=True)
    _tree_equal(final, direct)
    with ShardIndex(tmp_path / "f.extpu") as idx:
        name, arrays = idx.entry(n - 1)
        assert name == f"chunk_{n:06d}"
        assert np.array_equal(arrays["['final_obs']"], obs.cpu().numpy())
        assert np.array_equal(arrays["['actions']"], slabs[-1].cpu().numpy())

    split = FleetRunner(ShardedEnv(env, make_batch_mesh(["cuda:0"] * 4)))
    assert split.rollout_path == "sharded_fused"
    K.KERNEL.reset_counts()
    _tree_equal(split.run(s0, lambda k: slabs[k], n, T), final)
    assert K.KERNEL.launches["step"] == 4 * n

    drive = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, dtype=dtype)
    _, d0 = drive.vmap_reset(rng=gen)
    v = [(torch.rand(B, T, 2, generator=gen, device="cuda") * 0.6 - 0.3).to(dtype) for _ in range(n)]
    prunner = FleetRunner(drive)
    assert prunner.rollout_path == "pmsm_fused"
    PK.KERNEL.reset_counts()
    pfinal = prunner.run(d0, lambda k: v[k], n, T)
    assert PK.KERNEL.launches["pmsm_step"] == n
    direct = d0
    for k in range(n):
        _, direct = drive.fused_rollout(direct, v[k], strict=True)
    _tree_equal(pfinal, direct)

    tracking = P.Pendulum(batch_size=B, dtype=dtype, control_state=["theta"])
    _, c0 = tracking.vmap_reset(rng=gen)
    c0.reference.theta = torch.linspace(-1.5, 1.5, B, device="cuda", dtype=dtype)
    pd = P.AffinePolicy(PD_GAINS)
    crunner = FleetRunner(tracking)
    CL.CL_KERNEL.reset_counts()
    cfinal = crunner.run_policy(c0, pd, n, T)
    assert crunner.closed_loop_path == "closed_loop_fused" and CL.CL_KERNEL.launches["closed_loop"] == n
    direct = c0
    for _ in range(n):
        _, direct = tracking.fused_closed_loop(direct, pd, T)
    _tree_equal(cfinal, direct)
    CL.CL_KERNEL.reset_counts()
    with pytest.raises(ValueError):
        FleetRunner(tracking).run_policy(c0, lambda obs, t: (-0.5 * obs[0],), 1, T)
    assert CL.CL_KERNEL.launches["closed_loop"] == 0

    pdrive = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, dtype=dtype,
                    control_state=["i_d", "i_q"])
    _, q0 = pdrive.vmap_reset(rng=gen)
    q0.reference.i_d = torch.linspace(-200.0, -10.0, B, device="cuda", dtype=dtype)
    q0.reference.i_q = torch.linspace(-150.0, 150.0, B, device="cuda", dtype=dtype)
    pi_law = P.AffinePolicy([[-0.6, 0, 0, 0, 0, 0, 0, 0, 0.6, 0], [0, -0.6, 0, 0, 0, 0, 0, 0, 0, 0.6]],
                            Ki=[[-0.01, 0, 0, 0, 0, 0, 0, 0, 0.01, 0], [0, -0.01, 0, 0, 0, 0, 0, 0, 0, 0.01]])
    carry0 = tuple(torch.zeros(B, device="cuda", dtype=dtype) for _ in range(2))
    qrunner = FleetRunner(pdrive)
    PCL.PMSM_CL_KERNEL.reset_counts()
    qfinal, qcarry = qrunner.run_policy(q0, pi_law, n, T, policy_carry=carry0)
    assert qrunner.closed_loop_path == "pmsm_closed_loop_fused"
    assert PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"] == n
    direct, carry = q0, carry0
    for _ in range(n):
        _, direct, carry = pdrive.fused_closed_loop(direct, pi_law, T, policy_carry=carry)
    _tree_equal((qfinal, qcarry), (direct, carry))


@pytest.mark.gpu
def test_device_loader_copies_through_pinned_memory_on_a_copy_stream(tmp_path):
    """``DeviceLoader`` onto ``cuda:0``: every leaf equal to the shard's
    bytes, copied on a stream other than the consumer's with an event the
    consumer's stream waits on; a consumer kernel reading the entry right
    away sees the whole copy; an early break leaves no worker thread."""
    import threading

    from exciting_environments_torch.io import DeviceLoader, ShardIndex, ShardWriter

    _cuda()
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(4096, 257)).astype(np.float32) for _ in range(4)]
    path = tmp_path / "d.extpu"
    with ShardWriter(path) as w:
        for i, a in enumerate(arrays):
            w.append({"x": a, "k": np.arange(5, dtype=np.int64) + i}, name=f"e{i}")
    copies = []
    orig_to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        out = orig_to(self, *args, **kwargs)
        if out.is_cuda and not self.is_cuda:
            copies.append((self.is_pinned(), kwargs.get("non_blocking", False), torch.cuda.current_stream().cuda_stream))
        return out

    torch.Tensor.to = spy
    try:
        sums = []
        for name, batch in DeviceLoader([path], prefetch=2):
            assert batch["['x']"].device == torch.device("cuda", 0)
            sums.append(batch["['x']"].double().sum())  # a consumer kernel on the current stream
            assert torch.equal(batch["['k']"].cpu(), torch.arange(5) + int(name[1:]))
    finally:
        torch.Tensor.to = orig_to
    consumer = torch.cuda.current_stream().cuda_stream
    assert len(copies) == 8 and all(pinned and nb and stream != consumer for pinned, nb, stream in copies)
    for s, a in zip(sums, arrays):  # float64 sums of float32 data: equal up to the summation order
        np.testing.assert_allclose(float(s), float(torch.as_tensor(a).double().sum()), rtol=1e-12)
    before = {t.ident for t in threading.enumerate()}
    for _ in DeviceLoader([path], prefetch=1):
        break
    assert not [t for t in threading.enumerate() if t.ident not in before]
    with ShardIndex(path) as idx:
        _, a0 = idx.entry(0)
        _, b0 = next(iter(DeviceLoader([path])))
        assert np.array_equal(b0["['x']"].cpu().numpy(), a0["['x']"])


def _profiled(fn):
    """``fn()`` under ``torch.profiler`` with the card's activity; returns
    its events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


def _host_spans(events):
    """``(start, end, name)`` of the program's host spans, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.name.startswith("ee.") and not str(e.device_type).endswith("CUDA"))


@pytest.mark.gpu
def test_fleet_launch_spans_count_the_launches(tmp_path):
    """A profiled ``FleetRunner.run`` on the card: the ``ee.launch.stepper.step``
    spans equal the increase of ``KERNEL.launches["step"]``; each chunk
    holds the entry point's prepare, launch and rebuild inside its enqueue
    and opens at most 12 spans with the sink, a checkpoint and the hook;
    and no ``ee.*`` name is among the device events that
    ``portbench/tracing.py`` keeps, so the benchmark's launch counts and
    idle shares count no span."""
    import sys
    from pathlib import Path

    from exciting_environments_torch.io import ShardWriter
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.utils.fleet import FleetRunner

    _cuda()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.tracing import TraceSummary

    B, T, n = 4096, 64, 4
    env = P.Pendulum(batch_size=B)
    _, s0 = env.vmap_reset(R.split(R.PRNGKey(0, "cuda"), B))
    gen = torch.Generator(device="cuda").manual_seed(1)
    slabs = [torch.rand((B, T, 1), device="cuda", generator=gen) * 2 - 1 for _ in range(n)]
    (tmp_path / "ckpt").mkdir()
    with ShardWriter(str(tmp_path / "run.extpu"), use_native=False) as writer:
        runner = FleetRunner(env, writer=writer, checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=1)
        runner.run(s0, lambda k: slabs[k], 1, T)  # the library's load outside the trace
        before = K.KERNEL.launches["step"]
        events = _profiled(lambda: runner.run(s0, lambda k: slabs[k], n, T, metric_hook=lambda *a: None))
    spans = _host_spans(events)
    assert K.KERNEL.launches["step"] - before == n == sum(name == "ee.launch.stepper.step" for *_, name in spans)
    chunks = [sp for sp in spans if sp[2] == "ee.fleet.chunk"]
    assert len(chunks) == n
    for c0, c1, _ in chunks:
        names = [name for s, e, name in spans if c0 < s and e <= c1]
        assert len(names) + 1 <= 12
        assert names[:6] == ["ee.fleet.actions", "ee.fleet.rollout", "ee.rollout.prepare", "ee.launch.stepper.step",
                             "ee.rollout.rebuild", "ee.fleet.stats"]
        assert names[6:] == ["ee.fleet.gate", "ee.fleet.readout", "ee.fleet.sink", "ee.fleet.checkpoint",
                             "ee.fleet.hook"]
    kept = TraceSummary(events, {}).device
    assert kept and not [name for *_, name in kept if name.startswith("ee.")]


@pytest.mark.gpu
def test_pmsm_entry_point_spans_on_the_card():
    """The PMSM entry points' spans on the card, saturated BRUSA:
    ``collect_fused`` records prepare, launch (one span per counted launch),
    rebuild and assemble, in that order, and a ``run_policy`` chunk holds
    the closed-loop kernel's prepare (the policy's spec inside it), launch
    and rebuild in its enqueue."""
    from exciting_environments_torch.ops import random as R
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
    from exciting_environments_torch.utils.collect import RolloutCollector
    from exciting_environments_torch.utils.fleet import FleetRunner

    _cuda()
    B, T = 1024, 32
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"])
    _, s0 = env.vmap_reset(R.split(R.PRNGKey(2, "cuda"), B))
    s0.reference.i_d = torch.linspace(-200.0, -10.0, B, device="cuda")
    s0.reference.i_q = torch.linspace(-150.0, 150.0, B, device="cuda")
    actions = 0.01 * torch.ones((B, T, 2), device="cuda")
    collector = RolloutCollector(env)
    collector.collect_fused(s0, actions)
    before = PK.KERNEL.launches["pmsm_step"]
    names = [name for *_, name in _host_spans(_profiled(lambda: collector.collect_fused(s0, actions)))]
    assert PK.KERNEL.launches["pmsm_step"] - before == 1
    assert names == ["ee.rollout.prepare", "ee.launch.pmsm_stepper.pmsm_step", "ee.rollout.rebuild",
                     "ee.collect.assemble"]

    law = P.AffinePolicy([[-0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0],
                          [0.0, -0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5]])
    runner = FleetRunner(env)
    runner.run_policy(s0, law, 1, T)
    before = PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"]
    names = [name for *_, name in _host_spans(_profiled(lambda: runner.run_policy(s0, law, 2, T)))]
    assert PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"] - before == 2
    assert names.count("ee.launch.pmsm_closed_loop.pmsm_closed_loop") == 2
    assert names[:6] == ["ee.fleet.chunk", "ee.fleet.rollout", "ee.rollout.prepare", "ee.policy.spec",
                         "ee.launch.pmsm_closed_loop.pmsm_closed_loop", "ee.rollout.rebuild"]


# ---------------------------------------------------------------------------
# csrc/pmsm_closed_loop_adjoint.cu: the PMSM closed loop's reverse sweep
# ---------------------------------------------------------------------------


def _adjoint_case(dtype, deadtime, integral, saturated=True, B=2048 + 37, T=24, seed=41, dense=True):
    """A drive fleet, a dense affine law, the forward's saves of every step
    (the kernel's launch) and seeded cotangents on every output (the
    carry's saves left ``None``): the arguments of ``kernel_pmsm_cl_adjoint``
    and of its plain version."""
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL

    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = lambda lo, hi, shape=(B,): (torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64)
                                     * (hi - lo) + lo).to(dtype)
    variant = P.MotorVariant.BRUSA if saturated else P.MotorVariant.DEFAULT
    params = dict(variant.get_params().static_params.__dict__, deadtime=deadtime)
    env = P.PMSM(batch_size=B, saturated=saturated, motor_variant=variant, static_params=params,
                 control_state=["i_d", "i_q"], dtype=dtype)
    state0 = (u(-150, 0), u(-150, 150), u(-3, 3), u(-80, 80), u(-80, 80))
    omega, refs = u(0, 1000), (u(-0.8, 0.0), u(-0.5, 0.5))
    rng = np.random.default_rng(seed)
    K = 3 * np.asarray(PCL_P) + (rng.normal(0, 0.05, (2, 10)) if dense else 0)
    policy = P.AffinePolicy(K, b=rng.normal(0, 0.1, 2) if dense else None,
                            Ki=(np.asarray(PCL_KI) + rng.normal(0, 0.002, (2, 10))) if integral else None)
    flat = policy.flat_params().to(device="cuda", dtype=dtype)
    carry0 = (u(-0.1, 0.1), u(-0.1, 0.1)) if integral else ()
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs, traj_stride=1,
              policy_params=flat, policy_carry=carry0 if integral else None)
    _, _, _, traj, _ = PCL.kernel_pmsm_closed_loop(env, state0, omega, policy, T, **kw)
    plane = lambda: u(0.5, 1.5, (T, B))
    cot = PCL.AdjointCotangents(tuple(plane() for _ in range(7)), (None, None) if integral else (),
                                tuple(u(0.5, 1.5) for _ in range(6)), (u(0.5, 1.5), None),
                                tuple(u(0.5, 1.5) for _ in carry0))
    return env, policy, flat, state0, omega, refs, carry0, traj, cot


ADJOINT_CASES = [(1, True, True), (0, True, True), (1, False, True), (0, False, True), (1, True, False),
                 (0, False, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("deadtime,integral,saturated", ADJOINT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pmsm_cl_adjoint_matches_its_plain_version(deadtime, integral, saturated, dtype):
    """The adjoint kernel against ``plain_pmsm_cl_adjoint`` on the same saves
    and cotangents: float64 to 1e-12 of each cotangent's largest magnitude,
    float32 within the tuning cell's ``grad_gap`` limit; the sums bit for
    bit from one launch to the next."""
    import json
    from pathlib import Path

    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop_adjoint as PCA

    _cuda()
    env, policy, flat, state0, omega, refs, carry0, traj, cot = _adjoint_case(dtype, deadtime, integral, saturated)
    kw = dict(tau=env.tau, props=env.env_properties)
    eps_starts = PCL._eps_starts(state0[2], omega, env.tau, env._solver, traj[0].shape[0], 1)
    got = PCA.kernel_pmsm_cl_adjoint(env, policy, flat, state0, omega, refs, carry0, traj, cot, **kw)
    want = PCL.plain_pmsm_cl_adjoint(env, policy, flat, state0, omega, refs, carry0, traj, eps_starts, cot, **kw)
    cell = Path(__file__).resolve().parents[1] / "portbench" / "workloads" / "pmsm-brusa-pi-tune-t256.json"
    limit = 1e-12 if dtype == torch.float64 else json.loads(cell.read_text())["limits"]["grad_gap"]
    flat_out = lambda out: [*out[0], *out[1], out[2]]
    for a, b in zip(flat_out(got), flat_out(want)):
        assert float((a.double() - b.double()).abs().max()) <= limit * float(b.double().abs().max())
    again = PCA.kernel_pmsm_cl_adjoint(env, policy, flat, state0, omega, refs, carry0, traj, cot, **kw)
    assert all(torch.equal(a, b) for a, b in zip(flat_out(got), flat_out(again)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pmsm_vjp_backward_takes_one_adjoint_launch(dtype):
    """A training step's backward through ``fused_closed_loop`` (a save every
    step, the gains and the start state requiring grad): one forward launch,
    one adjoint launch, counted in ``BACKWARD_PATHS``; the gradients agree
    with the eager replay that an out-of-scope input (a reference requiring
    grad) takes, float64 to 1e-12, float32 within the cell's limit."""
    import json
    from pathlib import Path

    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop_adjoint as PCA
    from exciting_environments_torch.utils.train import default_tracking_loss

    _cuda()
    B, T = 4096 + 5, 32
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"],
                 dtype=dtype)
    _, state = env.vmap_reset(rng=torch.Generator(device="cuda").manual_seed(7))
    state.reference.i_d = torch.linspace(-200.0, -10.0, B, device="cuda", dtype=dtype)
    state.reference.i_q = torch.linspace(-150.0, 150.0, B, device="cuda", dtype=dtype)
    policy = P.AffinePolicy(PCL_P, Ki=PCL_KI)
    loss_fn = default_tracking_loss(env)
    grads = []
    for replay in (False, True):
        gains = policy.flat_params().to(device="cuda", dtype=dtype).requires_grad_(True)
        i_d0 = state.physical_state.i_d.detach().clone().requires_grad_(True)
        st = P.core.structures.replace(state, physical_state=P.core.structures.replace(state.physical_state, i_d=i_d0))
        if replay:
            st.reference.i_q = st.reference.i_q.detach().clone().requires_grad_(True)
        carry = tuple(torch.zeros(B, device="cuda", dtype=dtype) for _ in range(2))
        before = (PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"], PCA.PMSM_CL_ADJOINT_KERNEL.launches["adjoint"],
                  PCL.BACKWARD_PATHS["adjoint"], PCL.BACKWARD_PATHS["replay"].get("inputs", 0))
        obs, acts, *_ = env.fused_closed_loop(st, policy, T, obs_stride=1, policy_params=gains, policy_carry=carry)
        loss = loss_fn(obs, acts)
        grads.append(torch.autograd.grad(loss, (gains, i_d0)))
        after = (PCL.PMSM_CL_KERNEL.launches["pmsm_closed_loop"], PCA.PMSM_CL_ADJOINT_KERNEL.launches["adjoint"],
                 PCL.BACKWARD_PATHS["adjoint"], PCL.BACKWARD_PATHS["replay"].get("inputs", 0))
        assert [a - b for a, b in zip(after, before)] == ([1, 0, 0, 1] if replay else [1, 1, 1, 0])
    cell = Path(__file__).resolve().parents[1] / "portbench" / "workloads" / "pmsm-brusa-pi-tune-t256.json"
    limit = 1e-12 if dtype == torch.float64 else json.loads(cell.read_text())["limits"]["grad_gap"]
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= limit * float(b.abs().max())


@pytest.mark.gpu
def test_pmsm_adjoint_routes_out_of_scope_calls_to_the_replay():
    """Each input the adjoint is not built for takes the replay, counted by
    its reason: a clipped law, RK4, a process-noise slab, checkpoints two
    steps apart."""
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL

    _cuda()
    B, T = 256, 8
    for reason, solver, clip, noise, stride in (("family", "euler", 1.0, False, 1), ("solver", "rk4", None, False, 1),
                                                ("noise", "euler", None, True, 1), ("segments", "euler", None, False, 4)):
        env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, solver=solver,
                     control_state=["i_d", "i_q"])
        _, st = env.vmap_reset(rng=torch.Generator(device="cuda").manual_seed(3))
        law = P.AffinePolicy(PCL_P, clip=clip)
        gains = law.flat_params().float().cuda().requires_grad_(True)
        kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, traj_stride=stride, policy_params=gains,
                  ref_leaves=(torch.zeros(B, device="cuda"),) * 2)
        if noise:
            kw.update(proc_noise_tm=torch.zeros((T, B, 1), device="cuda"), proc_noise_idx=(0,))
        phys = st.physical_state
        before = dict(PCL.BACKWARD_PATHS["replay"]), PCL.BACKWARD_PATHS["adjoint"]
        out = PCL.kernel_pmsm_closed_loop(env, (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer),
                                          phys.omega_el, law, T, **kw)
        torch.autograd.grad(out[0][0].sum() + out[3][0].sum(), gains)
        assert PCL.BACKWARD_PATHS["replay"].get(reason, 0) == before[0].get(reason, 0) + 1, reason
        assert PCL.BACKWARD_PATHS["adjoint"] == before[1]


@pytest.mark.gpu
def test_train_policy_lowers_its_loss_through_the_adjoint():
    """The tuning cell's size: ``train_policy`` over 65,536 saturated BRUSA
    drives, the PI law from the PI cell's gains, 256 steps, 12 iterations,
    every backward one adjoint launch; at an Adam lr that descends, 3e-4,
    the loss ends below its first value with every gain finite."""
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop_adjoint as PCA
    from exciting_environments_torch.utils.train import train_policy

    _cuda()
    B = 65536
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"])
    gen = torch.Generator(device="cuda").manual_seed(12)
    u = lambda lo, hi: torch.rand(B, generator=gen, device="cuda") * (hi - lo) + lo
    _, state = env.vmap_reset(rng=gen)
    phys = P.core.structures.replace(state.physical_state, i_d=u(-200, -10), i_q=u(-150, 150), epsilon=u(-3.1, 3.1),
                                     omega_el=u(0, 1000))
    state = P.core.structures.replace(state, physical_state=phys)
    state.reference.i_d, state.reference.i_q = u(-200, -10), u(-150, 150)
    policy = P.AffinePolicy(PCL_P, Ki=PCL_KI)
    carry = tuple(torch.zeros(B, device="cuda") for _ in range(2))
    before = PCA.PMSM_CL_ADJOINT_KERNEL.launches["adjoint"], PCL.BACKWARD_PATHS["adjoint"]
    # the default lr 0.1 (the cell's) makes the 42 raw gains' loop unstable after one step
    adam = lambda params: torch.optim.Adam(params, lr=3e-4)
    result = train_policy(env, policy, policy.flat_params().float().cuda(), state, 256, 12, optimizer=adam,
                          policy_carry=carry)
    assert PCA.PMSM_CL_ADJOINT_KERNEL.launches["adjoint"] - before[0] == 12
    assert PCL.BACKWARD_PATHS["adjoint"] - before[1] == 12
    assert result.losses[-1] < result.losses[0] and result.final_loss < float(result.losses[0])
    assert bool(torch.isfinite(result.params).all())


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "rk4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_angle_trajectory_kernel_matches_the_eager_loop(solver, dtype):
    """``csrc/pmsm_angles.cu`` gives ``_eps_trajectory``'s angles bit for bit,
    in one launch; a leaf that requires grad keeps the eager loop."""
    from exciting_environments_torch.ops.kernels import pmsm_angles as PA
    from exciting_environments_torch.ops.kernels.pmsm_stepper import _eps_trajectory
    from exciting_environments_torch.ops.solvers import RK4, Euler

    _cuda()
    B, T = 4096 + 7, 300
    gen = torch.Generator(device="cuda").manual_seed(5)
    eps0 = ((torch.rand(B, generator=gen, device="cuda", dtype=torch.float64) * 2 - 1) * 3.2).to(dtype)
    omega = ((torch.rand(B, generator=gen, device="cuda", dtype=torch.float64) * 2 - 1) * 3000).to(dtype)
    method = Euler() if solver == "euler" else RK4()
    before = PA.PMSM_ANGLES_KERNEL.launches["angles"]
    seq, final = PA.angle_trajectory(eps0, omega, 1e-4, T, method)
    want_seq, want_final = _eps_trajectory(eps0, omega, 1e-4, T, method)
    assert PA.PMSM_ANGLES_KERNEL.launches["angles"] == before + 1
    assert torch.equal(seq, want_seq) and torch.equal(final, want_final)
    leaf = eps0.clone().requires_grad_(True)
    seq_g, _ = PA.angle_trajectory(leaf, omega, 1e-4, 8, method)
    assert PA.PMSM_ANGLES_KERNEL.launches["angles"] == before + 1 and seq_g.requires_grad
