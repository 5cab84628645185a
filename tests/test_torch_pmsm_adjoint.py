"""The PMSM closed loop's hand-derived reverse sweep on the CPU, in float64:
``plain_pmsm_cl_adjoint`` (the plain version of
``csrc/pmsm_closed_loop_adjoint.cu``) against autograd's replay of the plain
step (``PmsmClosedLoopVJP`` on CPU tensors); the benchmark's independent
tuning reference (``portbench/reference/pmsm_brusa_tune.py``) against the
port's gradient of ``train_policy``'s loss through the plain loop and
through the replay; and the backward's routes (``adjoint_scope``,
``BACKWARD_PATHS``).  The kernel itself runs in ``tests/test_torch_gpu.py``."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import exciting_environments_torch as P
from exciting_environments_torch.core import structures
from exciting_environments_torch.ops.kernels import checkpoint as ck
from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
from exciting_environments_torch.ops.kernels import pmsm_closed_loop_adjoint as PCA
from exciting_environments_torch.ops.solvers import RK4, Euler
from exciting_environments_torch.utils.train import default_tracking_loss

F64 = dict(device="cpu", dtype=torch.float64)
B = 24
REL = 1e-12
K_P = np.array([[-0.6, 0, 0, 0, 0, 0, 0, 0, 0.6, 0], [0, -0.6, 0, 0, 0, 0, 0, 0, 0, 0.6]])
K_I = np.array([[-0.01, 0, 0, 0, 0, 0, 0, 0, 0.01, 0], [0, -0.01, 0, 0, 0, 0, 0, 0, 0, 0.01]])
REPO = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def _pmsm(saturated=True, deadtime=1, static=None, batch=B):
    variant = P.MotorVariant.BRUSA if saturated else P.MotorVariant.DEFAULT
    params = dict(variant.get_params().static_params.__dict__)
    if saturated:
        params.update(l_d=math.nan, l_q=math.nan, psi_p=math.nan)
    params.update(deadtime=deadtime, **(static or {}))
    return P.PMSM(batch_size=batch, saturated=saturated, motor_variant=variant, static_params=params,
                  control_state=["i_d", "i_q"], **F64)


ADJOINT_CASES = {
    "dt1-pi-edge": dict(deadtime=1, integral=True, scale=3.0),
    "dt0-pi-edge": dict(deadtime=0, integral=True, scale=3.0),
    "dt1-p-no-b": dict(deadtime=1, integral=False, scale=3.0, bias=False),
    "dt0-p-inside": dict(deadtime=0, integral=False, scale=0.05, inside=True),
    "dt1-pi-inside": dict(deadtime=1, integral=True, scale=0.05, inside=True),
    "zero-phasor": dict(deadtime=1, integral=True, zero=True),
    "linear-dt1-pi": dict(deadtime=1, integral=True, scale=3.0, saturated=False),
    "per-batch-bands": dict(deadtime=1, integral=True, scale=3.0, per_batch=True),
    "some-cotangents": dict(deadtime=0, integral=True, scale=3.0, sparse=True),
}


@pytest.mark.parametrize("case", list(ADJOINT_CASES))
def test_plain_adjoint_matches_the_replay(case):
    """The hand-derived reverse sweep against autograd's segment replay on the
    same inputs, cotangents on every output (or, in ``some-cotangents``, on
    a few of them, the rest ``None``), to 1e-12 of each cotangent's largest
    magnitude: the start leaves, the carry and the flat gains."""
    c = ADJOINT_CASES[case]
    rng = np.random.default_rng(len(case) + 50)
    T = 12
    static = dict(r_s=rng.uniform(15e-3, 21e-3, B), u_dc=rng.uniform(300.0, 450.0, B)) if c.get("per_batch") else {}
    env = _pmsm(c.get("saturated", True), c["deadtime"], static)
    zero = c.get("zero", False)
    if zero:
        state0 = (_t(rng.uniform(-150, 0, B)), _t(rng.uniform(-150, 150, B)), _t(rng.uniform(-3, 3, B)),
                  _t(np.zeros(B)), _t(np.zeros(B)))
        K, b, Ki = np.zeros((2, 10)), None, np.zeros((2, 10))
    else:
        state0 = tuple(_t(x) for x in (rng.uniform(-150, 0, B), rng.uniform(-150, 150, B), rng.uniform(-3, 3, B),
                                       rng.uniform(-80, 80, B), rng.uniform(-80, 80, B)))
        K = c["scale"] * K_P + c["scale"] * rng.normal(0, 0.05, (2, 10))
        b = rng.normal(0, 0.1 * c["scale"], 2) if c.get("bias", True) else None
        Ki = (K_I + rng.normal(0, 0.002, (2, 10))) * min(c["scale"], 1.0) if c["integral"] else None
    omega = _t(rng.uniform(300, 1500, B))
    refs = (_t(rng.uniform(-0.6, 0, B)), _t(rng.uniform(-0.5, 0.5, B)))
    policy = P.AffinePolicy(K, b=b, Ki=Ki)
    flat = policy.flat_params()
    nc = 2 if c["integral"] else 0
    carry0 = tuple(_t(rng.uniform(-0.1, 0.1, B) * (not zero)) for _ in range(nc))
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs, traj_stride=1)

    # the forward's saves, and seeded cotangents on its outputs
    _, _, _, traj, _ = PCL.plain_pmsm_closed_loop(env, state0, omega, policy, T, policy_params=flat,
                                                  policy_carry=carry0 or None, **kw)
    w = lambda shape: _t(rng.uniform(0.5, 1.5, shape))
    keep = (lambda i: i in (0, 1, 3)) if c.get("sparse") else (lambda i: True)
    cot = PCL.AdjointCotangents(tuple(w((T, B)) if keep(i) else None for i in range(7)),
                                tuple(w((T, B)) if keep(i) else None for i in range(nc)),
                                tuple(w(B) if keep(i) else None for i in range(6)),
                                tuple(w(B) if keep(i) else None for i in range(2)),
                                tuple(w(B) if keep(i) else None for i in range(nc)))
    if "inside" in case or "edge" in case:
        # a step is clipped where the constrained voltage is not the action's own
        # (the float32 sector rotations alone move it by ~1e-8 relative)
        (mnd, mxd), (mnq, mxq) = PCL.eff_cl_norms(PCL.cl_bands(env.env_properties))[1]
        volts = lambda a, mn, mx: (a + 1) / 2 * (mx - mn) + mn
        clipped = (traj[3] - volts(traj[5], mnd, mxd)).abs() + (traj[4] - volts(traj[6], mnq, mxq)).abs() > 1e-3
        assert bool(clipped.any()) == ("edge" in case) and not bool(clipped.all())

    eps_starts = PCL._eps_starts(state0[2], omega, env.tau, env._solver, T, 1)
    g_state, g_carry, g_flat = PCL.plain_pmsm_cl_adjoint(env, policy, flat, state0, omega, refs, carry0, traj,
                                                         eps_starts, cot, tau=env.tau, props=env.env_properties)

    leaves = [s.clone().requires_grad_(True) for s in state0]
    c_leaves = [x.clone().requires_grad_(True) for x in carry0]
    gains = flat.clone().requires_grad_(True)
    final, u_last, final_c, saves, c_saves = PCL.pmsm_closed_loop_vjp(
        env, tuple(leaves), omega, policy, T, policy_params=gains, policy_carry=tuple(c_leaves) or None, **kw)
    outs = [*final, *u_last, *final_c, *saves, *c_saves]
    cots = [*cot.final, *cot.u_last, *cot.carry, *cot.traj, *cot.traj_carry]
    loss = sum((o * g).sum() for o, g in zip(outs, cots) if g is not None)
    want = torch.autograd.grad(loss, leaves + c_leaves + [gains], allow_unused=True)
    for i, (a, b_) in enumerate(zip([*g_state, *g_carry, g_flat], want)):
        b_ = torch.zeros_like(a) if b_ is None else b_
        if float(b_.abs().max()) == 0:
            assert float(a.abs().max()) == 0, i
        else:
            assert _rel(a, b_) <= REL, (i, _rel(a, b_))


def _tune_reference():
    path = REPO / "portbench" / "reference" / "pmsm_brusa_tune.py"
    spec = importlib.util.spec_from_file_location("reference_pmsm_brusa_tune", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("path", ["plain", "replay"])
def test_tuning_reference_matches_the_ports_gradient(path):
    """``train_policy``'s loss and its gradient in the 42 gains of the PI law
    at B = 64, T = 32, from the PI cell's ranges and gains: the benchmark's
    independent float64 reference against the port (autograd through the
    plain loop, or the checkpointed replay behind ``fused_closed_loop``),
    to 1e-12."""
    ref = _tune_reference()
    batch, T = 64, 32
    gen = torch.Generator().manual_seed(2 ** 31 + 29)
    u = lambda lo, hi: torch.rand(batch, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    env = _pmsm(deadtime=1, batch=batch)
    start = (u(-200, -10), u(-150, 150), u(-math.pi, math.pi), torch.zeros(batch, **F64), torch.zeros(batch, **F64))
    omega, refs = u(0, 1000), (u(-200, -10), u(-150, 150))
    carry = (torch.zeros(batch, **F64), torch.zeros(batch, **F64))
    policy = P.AffinePolicy(K_P, Ki=K_I)
    # gains a few Adam steps off the start, every one of them nonzero
    gains = (policy.flat_params() + _t(np.random.default_rng(3).normal(0, 0.02, 42))).requires_grad_(True)
    _, state = env.vmap_reset(rng=torch.Generator().manual_seed(1))
    phys = structures.replace(state.physical_state, i_d=start[0], i_q=start[1], epsilon=start[2],
                              u_d_buffer=start[3], u_q_buffer=start[4], omega_el=omega)
    state = structures.replace(state, physical_state=phys)
    state.reference.i_d, state.reference.i_q = refs
    loss_fn = default_tracking_loss(env)
    if path == "replay":
        obs, acts, *_ = env.fused_closed_loop(state, policy, T, obs_stride=1, policy_params=gains, policy_carry=carry)
        loss = loss_fn(obs, acts)
    else:
        norm = env.env_properties.physical_normalizations
        r = (norm.i_d.normalize(refs[0]), norm.i_q.normalize(refs[1]))
        _, _, _, traj, _ = PCL.plain_pmsm_closed_loop(
            env, start, omega, policy, T, tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=r,
            traj_stride=1, policy_params=gains, policy_carry=carry)
        loss = sum(torch.mean((norm_leaf.normalize(x) - rr[None]) ** 2)
                   for norm_leaf, x, rr in ((norm.i_d, traj[0], r[0]), (norm.i_q, traj[1], r[1])))
    (grad,) = torch.autograd.grad(loss, gains)
    want_loss, want_grad = ref.loss_and_grad(start, omega, refs, carry, gains.detach(), T, env.tau, torch.float64)
    assert abs(float(loss.detach()) - float(want_loss)) <= REL * float(want_loss)
    assert _rel(grad, want_grad) <= REL
    assert bool((want_grad != 0).all())


def test_obs_stride_one_gives_one_step_segments():
    assert all(ck.ckpt_stride(n, 1) == 1 for n in (1, 7, 256, 2048))
    assert ck.ckpt_stride(256, None) > 1 and ck.ckpt_stride(256, 2) == 2


def test_adjoint_scope_names_each_reason():
    """Every input the adjoint is not built for names its reason; the
    training iteration's inputs name none."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    pi = P.AffinePolicy(K_P, Ki=K_I)
    euler, rk4 = Euler(), RK4()
    base = dict(device=cuda, policy=pi, solver=euler, n_steps=256, traj_stride=1, noise=False, sched_lut=None,
                needs_omega_refs_props=False)
    assert PCA.adjoint_scope(**base) == ""
    assert PCA.adjoint_scope(**dict(base, n_steps=3, traj_stride=None)) == ""
    actor = P.AffinePolicy(K_P)
    actor.policy_id = 1
    for reason, change in (("cpu", dict(device=cpu)), ("family", dict(policy=P.AffinePolicy(K_P, clip=1.0))),
                           ("family", dict(policy=actor)), ("solver", dict(solver=rk4)), ("noise", dict(noise=True)),
                           ("schedule", dict(sched_lut=object())), ("segments", dict(traj_stride=4)),
                           ("segments", dict(traj_stride=None)), ("inputs", dict(needs_omega_refs_props=True))):
        assert PCA.adjoint_scope(**dict(base, **change)) == reason, (reason, change)


def test_a_cpu_backward_replays_and_counts_it():
    """On CPU tensors the backward replays, counted under ``"cpu"``; the
    adjoint's counter does not move."""
    env = _pmsm(batch=8)
    _, st = env.vmap_reset(rng=torch.Generator().manual_seed(1))
    st.reference.i_d = torch.full((8,), -50.0, **F64)
    st.reference.i_q = torch.full((8,), 20.0, **F64)
    policy = P.AffinePolicy(K_P, Ki=K_I)
    gains = policy.flat_params().requires_grad_(True)
    before = PCL.BACKWARD_PATHS["adjoint"], PCL.BACKWARD_PATHS["replay"].get("cpu", 0)
    obs, acts, *_ = env.fused_closed_loop(st, policy, 6, obs_stride=1, policy_params=gains,
                                          policy_carry=(torch.zeros(8, **F64),) * 2)
    obs[:, :, 0].sum().backward()
    assert PCL.BACKWARD_PATHS["adjoint"] == before[0]
    assert PCL.BACKWARD_PATHS["replay"]["cpu"] == before[1] + 1
    assert bool(torch.isfinite(gains.grad).all()) and float(gains.grad.abs().max()) > 0
