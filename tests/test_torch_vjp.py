"""The exact kernels' backward passes (the checkpointed VJPs of
``ops/kernels/{stepper,closed_loop,pmsm_stepper,pmsm_closed_loop}.py``) on
CPU tensors.

On the CPU each ``autograd.Function`` runs its kernel's plain loop forward
with checkpoint saves and no graph, and its backward replays the plain step
segment by segment, as it does after a kernel launch on the card.  Two kinds
of check, float64, a few dozen instances and tens of steps, inputs drawn
from a seeded numpy generator:

* against autograd through the whole plain loop (``plain_rollout``,
  ``plain_closed_loop``, ``plain_pmsm_rollout``, ``plain_pmsm_closed_loop``
  called directly), with a loss that touches every output: the max abs
  deviation of each cotangent stays within 1e-12 of the reference
  cotangent's max abs;
* against ``jax.grad`` of the JAX package's scan paths (``tile_policy_scan``,
  ``vmap_rollout``, ``vmap_sim_ahead``, a scan of ``env.step``), at the
  reference's own tolerances (tests/test_differentiability.py: 1e-9
  relative per parameter; state cotangents rtol 1e-9, atol 1e-12).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.ops.pallas.stepper import _ckpt_stride
from exciting_environments_tpu.utils.collect import tile_policy_scan as j_tile_policy_scan
from exciting_environments_torch.ops.kernels import checkpoint as ck
from exciting_environments_torch.ops.kernels import closed_loop as CL
from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
from exciting_environments_torch.ops.kernels import pmsm_stepper as PK
from exciting_environments_torch.ops.kernels import stepper as K
from exciting_environments_torch.utils.convert import actor_params_from_numpy, state_from_numpy
from exciting_environments_torch.utils.rl_fused import ActorPolicy

F64 = dict(device="cpu", dtype=torch.float64)
B = 24
REL = 1e-12
K_P = [[-0.6, 0, 0, 0, 0, 0, 0, 0, 0.6, 0], [0, -0.6, 0, 0, 0, 0, 0, 0, 0, 0.6]]
K_I = [[-0.01, 0, 0, 0, 0, 0, 0, 0, 0.01, 0], [0, -0.01, 0, 0, 0, 0, 0, 0, 0, 0.01]]


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _leaf(x):
    return _t(x).clone().requires_grad_(True)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def _loss(outputs, seed):
    """A linear loss over every output tensor, with seeded weights: its
    cotangents are those weights, the same on both sides."""
    rng = np.random.default_rng(seed)
    return sum((x * _t(rng.uniform(0.5, 1.5, tuple(x.shape)))).sum() for x in outputs if x is not None)


def _flat(out):
    """The tensors of a nest of tuples and ``None``."""
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def _check(fn_vjp, fn_plain, inputs, seed):
    """Cotangents of the VJP path against autograd through the plain loop,
    both called on the same leaves."""
    g1 = torch.autograd.grad(_loss(_flat(fn_vjp()), seed), inputs, allow_unused=True)
    g2 = torch.autograd.grad(_loss(_flat(fn_plain()), seed), inputs, allow_unused=True)
    for i, (a, b) in enumerate(zip(g1, g2)):
        assert b is not None and float(b.abs().max()) > 0, f"input {i} has no reference cotangent"
        assert a is not None, f"input {i} got no cotangent"
        assert _rel(a, b) <= REL, (i, _rel(a, b))


def _props_leaves(props):
    """``props`` with fresh leaves for its floating tensors, and those leaves."""
    leaves = [leaf.detach().clone().requires_grad_(True) for leaf in ck.prop_tensors(props)]
    return ck.props_with(props, leaves), leaves


# ---------------------------------------------------------------------------
# the shared pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_steps,stride", [(12, None), (13, None), (64, 16), (60, 12), (1024, 64), (97, 97),
                                            (24, 1), (36, None)])
def test_ckpt_stride_matches_jax(n_steps, stride):
    assert ck.ckpt_stride(n_steps, stride) == _ckpt_stride(n_steps, stride)


def test_inject_and_starts():
    g = _t(np.arange(6.0).reshape(3, 2))
    seg = ck.inject((g, None), 2, 6)
    assert seg[1] is None
    np.testing.assert_array_equal(seg[0].numpy(), [[0, 0], [0, 1], [0, 0], [2, 3], [0, 0], [4, 5]])
    (s,) = ck.starts((_t([9.0, 9.0]),), (g,))
    np.testing.assert_array_equal(s.numpy(), [[9, 9], [0, 1], [2, 3]])


# ---------------------------------------------------------------------------
# each VJP against autograd through the whole plain loop
# ---------------------------------------------------------------------------

ROLLOUT_CASES = {
    "euler": dict(name="Pendulum", solver="euler", T=12, stride=None),
    "rk4-ckpt-below-stride": dict(name="Pendulum", solver="rk4", T=16, stride=8),
    "rk4-prime": dict(name="Pendulum", solver="rk4", T=13, stride=None),
    "tsit5-cartpole": dict(name="CartPole", solver="tsit5", T=12, stride=6),
    "sim-ahead-rk4-hold2": dict(name="Pendulum", solver="rk4", T=12, stride=4, sim_ahead=True, hold=2),
    "sim-ahead-tsit5": dict(name="Pendulum", solver="tsit5", T=12, stride=3, sim_ahead=True),
    "noise": dict(name="Pendulum", solver="euler", T=12, stride=4, noise=True),
    "per-batch-l-and-band": dict(name="Pendulum", solver="rk4", T=12, stride=4, per_batch=True),
    "batch-major": dict(name="Pendulum", solver="rk4", T=12, stride=4, batch_major=True),
}


@pytest.mark.parametrize("case", list(ROLLOUT_CASES))
def test_rollout_vjp_matches_autograd_through_plain_loop(case):
    c = dict(ROLLOUT_CASES[case])
    rng = np.random.default_rng(len(case))
    extra = {}
    if c.get("per_batch"):
        extra = dict(static_params={"l": 1.0 + np.arange(B) / B, "g": 9.81, "m": 1},
                     action_normalizations={"torque": P.MinMaxNormalization(min=-20.0, max=np.linspace(15, 25, B))})
    env = getattr(P, c["name"])(batch_size=B, solver=c["solver"], **extra, **F64)
    props, pt = _props_leaves(env.env_properties)
    hold = c.get("hold", 1)
    y0 = tuple(_leaf(rng.uniform(-1, 1, B)) for _ in env._ode_state_fields)
    acts = _leaf(rng.uniform(-0.9, 0.9, (c["T"] // hold, B, env.action_dim)))
    noise = _leaf(rng.normal(0, 0.05, (c["T"], B, 1))) if c.get("noise") else None
    kw = dict(tau=env.tau, props=props, obs_stride=c["stride"], sim_ahead=c.get("sim_ahead", False), hold=hold,
              noise_tm=noise, noise_idx=(1,) if noise is not None else ())
    if c.get("batch_major"):
        vjp = lambda: K.rollout_vjp(env, y0, acts.transpose(0, 1), batch_major=True, **kw)
    else:
        def vjp():  # the entry point returns batch-major saves; the plain loop time-major ones
            final, traj = K.fused_rollout(env, y0, acts, time_major=True, **kw)
            return final, (None if traj is None else tuple(t.transpose(0, 1) for t in traj))
    inputs = [*y0, acts, *pt] + ([noise] if noise is not None else [])
    _check(vjp, lambda: K.plain_rollout(env, y0, acts, **kw), inputs, seed=1)


def _actor_tree(n_obs, rng):
    sizes = (n_obs, 16, 16, 1)
    return {"actor": [{"w": rng.normal(0.0, 1.0 / np.sqrt(m), (m, n)), "b": rng.normal(0.0, 0.1, n)}
                      for m, n in zip(sizes[:-1], sizes[1:])], "log_std": np.full(1, -1.0), "seed": 3.0}


CL_CASES = {
    "pd-euler": dict(name="Pendulum", solver="euler", T=12, stride=None),
    "pd-rk4-ckpt-below-stride": dict(name="Pendulum", solver="rk4", T=16, stride=8),
    "pd-prime": dict(name="Pendulum", solver="rk4", T=13, stride=None),
    "pi-noise-slabs": dict(name="Pendulum", solver="rk4", T=12, stride=4, pi=True, noise=True),
    "pd-per-batch-l": dict(name="Pendulum", solver="euler", T=12, stride=6, per_batch=True),
    "pd-tsit5-cartpole": dict(name="CartPole", solver="tsit5", T=12, stride=4),
    "actor-16x16": dict(name="Pendulum", solver="rk4", T=12, stride=4, actor=True),
    # the inverter circle binds on part of the fleet (a bias of 0.8 on both
    # axes: |u| up to 1.13 x 325 V against 231 V)
    "im-u_dc-rk4": dict(name="InductionMachine", solver="rk4", T=12, stride=4, control="i_sd", u_dc=400.0,
                        bias=0.8),
    "eesm-u_dc-euler": dict(name="EESM", solver="euler", T=12, stride=None, control="i_d", u_dc=400.0, bias=0.8),
}


@pytest.mark.parametrize("case", list(CL_CASES))
def test_closed_loop_vjp_matches_autograd_through_plain_loop(case):
    c = CL_CASES[case]
    rng = np.random.default_rng(len(case) + 10)
    control = [c.get("control", "theta" if c["name"] == "Pendulum" else "deflection")]
    extra = dict(static_params={"l": 1.0 + np.arange(B) / B, "g": 9.81, "m": 1}) if c.get("per_batch") else {}
    extra.update({"u_dc": c["u_dc"]} if "u_dc" in c else {})
    env = getattr(P, c["name"])(batch_size=B, solver=c["solver"], control_state=control, **extra, **F64)
    props, pt = _props_leaves(env.env_properties)
    n_state = len(env._ode_state_fields)
    y0 = tuple(_leaf(rng.uniform(-1, 1, B)) for _ in range(n_state))
    refs = (_leaf(rng.uniform(-0.8, 0.8, B)),)
    carry0, policy_params = None, None
    if c.get("actor"):
        policy = ActorPolicy(1, deterministic=True)
        tree = actor_params_from_numpy(env, _actor_tree(n_state + 1, rng))
        policy_params = {"actor": [{k: v.requires_grad_(True) for k, v in layer.items()} for layer in tree["actor"]],
                         "log_std": tree["log_std"], "seed": tree["seed"]}
        carry0 = (torch.arange(B, dtype=torch.float64),)
        grads_of = ck.tensors(policy_params["actor"])
    else:
        K0 = rng.uniform(-1.0, 1.0, (env.action_dim, n_state + 1))
        policy = P.AffinePolicy(K0, b=np.full(env.action_dim, c.get("bias", 0.0)),
                                Ki=rng.uniform(-0.05, 0.05, (1, n_state + 1)) if c.get("pi") else None)
        policy_params = _leaf(policy.flat_params().numpy())
        grads_of = [policy_params]
        if c.get("pi"):
            carry0 = (_leaf(rng.uniform(-0.1, 0.1, B)),)
            grads_of += list(carry0)
    on = _leaf(rng.normal(0, 0.02, (c["T"], B, 2))) if c.get("noise") else None
    pn = _leaf(rng.normal(0, 0.02, (c["T"], B, 1))) if c.get("noise") else None
    kw = dict(tau=env.tau, solver=env._solver, props=props, ref_leaves=refs, traj_stride=c["stride"],
              policy_params=policy_params, policy_carry=carry0, obs_noise_tm=on, proc_noise_tm=pn,
              obs_noise_cols=(0, n_state) if on is not None else (), proc_noise_idx=(1,) if pn is not None else ())
    inputs = [*y0, *refs, *grads_of, *pt] + [x for x in (on, pn) if x is not None]
    _check(lambda: CL.closed_loop_vjp(env, y0, policy, c["T"], **kw),
           lambda: CL.plain_closed_loop(env, y0, policy, c["T"], **kw), inputs, seed=2)


def _pmsm(variant="BRUSA", saturated=True, solver="euler", deadtime=1, static=None, control=None):
    params = dict(P.MotorVariant[variant].get_params().static_params.__dict__)
    if saturated:
        params.update(l_d=math.nan, l_q=math.nan, psi_p=math.nan)
    params.update(deadtime=deadtime, **(static or {}))
    return P.PMSM(batch_size=B, saturated=saturated, motor_variant=P.MotorVariant[variant], solver=solver,
                  static_params=params, control_state=control or [], **F64)


def _pmsm_state(rng):
    return (_leaf(rng.uniform(-150, 0, B)), _leaf(rng.uniform(-150, 150, B)), _leaf(rng.uniform(-3, 3, B)),
            _leaf(rng.uniform(-80, 80, B)), _leaf(rng.uniform(-80, 80, B))), _leaf(rng.uniform(300, 1500, B))


PMSM_CASES = {
    "dt1": dict(T=12, stride=None),
    "dt0-stride": dict(T=12, stride=4, deadtime=0),
    "dt1-ckpt-below-stride": dict(T=16, stride=8),
    "prime": dict(T=13, stride=None),
    "rk4": dict(T=12, stride=6, solver="rk4"),
    "sim-ahead-tsit5-dt1": dict(T=12, stride=1, solver="tsit5", sim_ahead=True),
    "sim-ahead-tsit5-dt0": dict(T=12, stride=1, solver="tsit5", sim_ahead=True, deadtime=0),
    "batch-major": dict(T=12, stride=3, batch_major=True),
    "per-batch-bands": dict(T=12, stride=4, per_batch=True),
    "linear-rk4": dict(T=12, stride=4, solver="rk4", variant="DEFAULT", saturated=False),
}


def _per_batch_static(rng):
    return dict(r_s=rng.uniform(15e-3, 21e-3, B), u_dc=rng.uniform(300.0, 450.0, B))


@pytest.mark.parametrize("case", list(PMSM_CASES))
def test_pmsm_rollout_vjp_matches_autograd_through_plain_loop(case):
    c = PMSM_CASES[case]
    rng = np.random.default_rng(len(case) + 20)
    env = _pmsm(c.get("variant", "BRUSA"), c.get("saturated", True), c.get("solver", "euler"),
                c.get("deadtime", 1), _per_batch_static(rng) if c.get("per_batch") else None)
    props, pt = _props_leaves(env.env_properties)
    state0, omega = _pmsm_state(rng)
    # full-scale actions: the hexagon clips some, so the DC link gets a real
    # cotangent (where it does not clip, u_dc cancels)
    acts = _leaf(rng.uniform(-1.0, 1.0, (c["T"], B, 2)))
    kw = dict(tau=env.tau, props=props, obs_stride=c["stride"], sim_ahead=c.get("sim_ahead", False))
    if c.get("batch_major"):
        vjp = lambda: PK.pmsm_rollout_vjp(env, acts.transpose(0, 1), state0, omega, batch_major=True, **kw)
    else:
        vjp = lambda: PK.pmsm_rollout(env, acts, state0, omega, **kw)
    _check(vjp, lambda: PK.plain_pmsm_rollout(env, acts, state0, omega, **kw), [acts, *state0, omega, *pt], seed=3)


PCL_CASES = {
    "p-dt1": dict(T=12, stride=None),
    "p-dt0-stride": dict(T=12, stride=4, deadtime=0),
    "pi-ckpt-below-stride": dict(T=16, stride=8, pi=True),
    "pi-prime": dict(T=13, stride=None, pi=True),
    "p-rk4-noise-slabs": dict(T=12, stride=6, solver="rk4", noise=True),
    "p-tsit5": dict(T=12, stride=1, solver="tsit5", deadtime=0),
    "p-per-batch-bands": dict(T=12, stride=4, per_batch=True),
    "p-linear": dict(T=12, stride=3, solver="rk4", variant="DEFAULT", saturated=False),
}


@pytest.mark.parametrize("case", list(PCL_CASES))
def test_pmsm_closed_loop_vjp_matches_autograd_through_plain_loop(case):
    c = PCL_CASES[case]
    rng = np.random.default_rng(len(case) + 30)
    static = _per_batch_static(rng) if c.get("per_batch") else {}
    env = _pmsm(c.get("variant", "BRUSA"), c.get("saturated", True), c.get("solver", "euler"), c.get("deadtime", 1),
                static, control=["i_d", "i_q"])
    if c.get("per_batch"):
        an = env.env_properties.action_normalizations
        an.u_d.max = torch.as_tensor(rng.uniform(0.8, 1.0, B) * an.u_d.max)
    props, pt = _props_leaves(env.env_properties)
    state0, omega = _pmsm_state(rng)
    refs = (_leaf(rng.uniform(-0.6, 0.0, B)), _leaf(rng.uniform(-0.5, 0.5, B)))
    policy = P.AffinePolicy(np.asarray(K_P) * 3, Ki=K_I if c.get("pi") else None)
    gains = _leaf(policy.flat_params().numpy())
    carry0 = (_leaf(rng.uniform(-0.1, 0.1, B)), _leaf(rng.uniform(-0.1, 0.1, B))) if c.get("pi") else None
    on = _leaf(rng.normal(0, 0.02, (c["T"], B, 2))) if c.get("noise") else None
    pn = _leaf(rng.normal(0, 0.5, (c["T"], B, 1))) if c.get("noise") else None
    kw = dict(tau=env.tau, solver=env._solver, props=props, ref_leaves=refs, traj_stride=c["stride"],
              policy_params=gains, policy_carry=carry0, obs_noise_tm=on, proc_noise_tm=pn,
              obs_noise_cols=(0, 1) if on is not None else (), proc_noise_idx=(1,) if pn is not None else ())
    inputs = [*state0, omega, *refs, gains, *(carry0 or ()), *pt] + [x for x in (on, pn) if x is not None]
    _check(lambda: PCL.pmsm_closed_loop(env, state0, omega, policy, c["T"], **kw),
           lambda: PCL.plain_pmsm_closed_loop(env, state0, omega, policy, c["T"], **kw), inputs, seed=4)


# ---------------------------------------------------------------------------
# dispatch: the Function only where autograd records, a second derivative
# raises, the kernel wrappers still refuse CPU tensors
# ---------------------------------------------------------------------------


def _small_calls():
    """One call of each entry point on CPU tensors: ``{name: (fn(x), x)}``,
    ``x`` the leaf the call is differentiated in."""
    rng = np.random.default_rng(40)
    pend = P.Pendulum(batch_size=B, control_state=["theta"], **F64)
    drive = _pmsm(control=["i_d", "i_q"])
    y0 = tuple(_t(rng.uniform(-1, 1, B)) for _ in range(2))
    (state0, omega) = _pmsm_state(rng)
    state0 = tuple(s.detach() for s in state0)
    omega = omega.detach()
    refs = (_t(rng.uniform(-0.5, 0.5, B)),)
    pd = P.AffinePolicy([[-0.9, -0.25, 0.9]])
    p_law = P.AffinePolicy(K_P)
    return {
        "rollout": (lambda a: K.fused_rollout(pend, y0, a, tau=pend.tau, time_major=True)[0],
                    _t(rng.uniform(-0.5, 0.5, (8, B, 1)))),
        "closed_loop": (lambda g: CL.fused_closed_loop(pend, y0, pd, 8, ref_leaves=refs, policy_params=g),
                        pd.flat_params()),
        "pmsm_rollout": (lambda a: PK.pmsm_rollout(drive, a, state0, omega, tau=drive.tau)[0],
                         _t(rng.uniform(-0.5, 0.5, (8, B, 2)))),
        "pmsm_closed_loop": (lambda g: PCL.pmsm_closed_loop(drive, state0, omega, p_law, 8, ref_leaves=refs * 2,
                                                            policy_params=g)[0], p_law.flat_params()),
    }


FUNCTIONS = {"rollout": K.RolloutVJP, "closed_loop": CL.ClosedLoopVJP, "pmsm_rollout": PK.PmsmRolloutVJP,
             "pmsm_closed_loop": PCL.PmsmClosedLoopVJP}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_second_derivative_raises(name):
    fn, x = _small_calls()[name]
    x = x.clone().requires_grad_(True)
    loss = sum((o ** 2).sum() for o in fn(x))
    (g,) = torch.autograd.grad(loss, [x], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        g.sum().backward()


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_no_grad_calls_skip_the_function(name, monkeypatch):
    """Without a recorded gradient the entry points run as before (no
    Function, no checkpoint saves), and with one they go through it."""
    calls = []
    function = FUNCTIONS[name]
    original = function.apply
    monkeypatch.setattr(function, "apply", lambda *a: calls.append(1) or original(*a))
    fn, x = _small_calls()[name]
    plain = fn(x)
    with torch.no_grad():
        fn(x.clone().requires_grad_(True))
    assert calls == []
    out = fn(x.clone().requires_grad_(True))
    assert calls == [1]
    for a, b in zip(_flat(out), _flat(plain)):
        assert torch.equal(a.detach(), b)


def test_kernel_wrappers_refuse_cpu_tensors_that_require_grad():
    pend = P.Pendulum(batch_size=B, control_state=["theta"], **F64)
    y0 = (torch.zeros(B, dtype=torch.float64, requires_grad=True), torch.zeros(B, dtype=torch.float64))
    acts = torch.zeros((4, B, 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.kernel_rollout(pend, y0, acts, tau=pend.tau)
    with pytest.raises(ValueError, match="CUDA tensors"):
        CL.kernel_closed_loop(pend, y0, P.AffinePolicy([[-0.9, -0.25, 0.9]]), 4, tau=pend.tau, solver=pend._solver,
                              props=pend.env_properties, ref_leaves=(torch.zeros(B, dtype=torch.float64),))
    drive = _pmsm()
    state0 = tuple(torch.zeros(B, dtype=torch.float64, requires_grad=True) for _ in range(5))
    with pytest.raises(ValueError, match="CUDA tensors"):
        PK.pmsm_kernel_rollout(drive, torch.zeros((4, B, 2), dtype=torch.float64), state0, state0[0], tau=drive.tau)


def test_actor_seed_gets_no_cotangent():
    rng = np.random.default_rng(50)
    env = P.Pendulum(batch_size=B, control_state=["theta"], **F64)
    tree = actor_params_from_numpy(env, _actor_tree(3, rng))
    tree["seed"].requires_grad_(True)
    tree["actor"][0]["w"].requires_grad_(True)
    y0 = tuple(_t(rng.uniform(-1, 1, B)) for _ in range(2))
    out = CL.fused_closed_loop(env, y0, ActorPolicy(1, deterministic=True), 6, ref_leaves=(_t(np.zeros(B)),),
                               policy_params=tree, policy_carry=(torch.arange(B, dtype=torch.float64),))
    g_w, g_seed = torch.autograd.grad(sum((o ** 2).sum() for o in out[0]), [tree["actor"][0]["w"], tree["seed"]])
    assert float(g_w.abs().max()) > 0 and float(g_seed.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# against jax.grad of the JAX package's scan paths
# ---------------------------------------------------------------------------


def _jax_state(je, x0, refs=None):
    _, js = je.vmap_reset()
    with jstructures.copy_and_mutate(js) as js:
        for n, v in x0.items():
            setattr(js.physical_state, n, jnp.asarray(v))
        for n, v in (refs or {}).items():
            setattr(js.reference, n, jnp.asarray(v))
    return js


def _close_param(got, want, rel=1e-9):
    assert abs(got - want) <= rel * max(abs(want), 1e-12), (got, want)


@pytest.mark.parametrize("family", ["callable", "AffinePolicy"])
def test_policy_gradient_matches_jax(family):
    """tests/test_differentiability.py::test_policy_gradient_through_closed_loop_kernel,
    with the PD law as a callable over ``{k1, k2}`` and as an ``AffinePolicy``
    whose gains autograd builds from them."""
    n, T = 64, 8
    rng = np.random.default_rng(60)
    x0 = {"theta": rng.uniform(-1, 1, n), "omega": rng.uniform(-1, 1, n)}
    refs = {"theta": np.linspace(-1.2, 1.2, n)}
    je = J.Pendulum(batch_size=n, control_state=["theta"])
    pe = P.Pendulum(batch_size=n, control_state=["theta"], **F64)
    js, ps = _jax_state(je, x0, refs), state_from_numpy(pe, x0, reference=refs)

    def j_law(obs, t, p):
        return (-p["k1"] * (obs[0] - obs[2]) - p["k2"] * obs[1],)

    def j_loss(p):
        obs = j_tile_policy_scan(je, js, T, j_law, p, True)[0]
        return jnp.mean((obs[:, :, 0] - obs[:, :, 2]) ** 2)

    p_j = {"k1": jnp.asarray(0.9), "k2": jnp.asarray(0.25)}
    g_j = jax.grad(j_loss)(p_j)
    p_t = {k: torch.tensor(float(v), dtype=torch.float64, requires_grad=True) for k, v in p_j.items()}
    if family == "callable":
        policy, params = j_law, p_t
    else:
        policy = P.AffinePolicy([[0.0, 0.0, 0.0]])
        params = torch.cat([torch.stack([-p_t["k1"], -p_t["k2"], p_t["k1"]]), torch.zeros(1, dtype=torch.float64)])
    obs, _, _ = pe.fused_closed_loop(ps, policy, T, obs_stride=1, policy_params=params)
    torch.mean((obs[:, :, 0] - obs[:, :, 2]) ** 2).backward()
    for k in p_j:
        _close_param(float(p_t[k].grad), float(g_j[k]))


def test_policy_gradient_through_the_inverter_limit_matches_jax():
    """The closed loop's VJP differentiates through the induction machine's
    inverter circle (``u_dc``), as the reference's replay does: a P law on
    both voltage axes whose bias drives part of the fleet beyond the circle,
    against ``jax.grad`` of the JAX package's ``tile_policy_scan``."""
    n, T = 64, 8
    rng = np.random.default_rng(62)
    x0 = {f: rng.uniform(-2, 2, n) for f in ("i_sd", "i_sq", "psi_rd", "psi_rq")}
    refs = {"i_sd": np.linspace(-0.5, 0.5, n)}
    je = J.InductionMachine(batch_size=n, control_state=["i_sd"], u_dc=400.0, solver="rk4")
    pe = P.InductionMachine(batch_size=n, control_state=["i_sd"], u_dc=400.0, solver="rk4", **F64)
    js, ps = _jax_state(je, x0, refs), state_from_numpy(pe, x0, reference=refs)

    def j_law(obs, t, p):
        return (p["kp"] * (obs[4] - obs[0]) + p["b"], p["kp"] * (0.0 - obs[1]) + 0.9 * p["b"])

    def j_loss(p):
        obs = j_tile_policy_scan(je, js, T, j_law, p, True)[0]
        return jnp.mean((obs[:, :, 0] - obs[:, :, 4]) ** 2) + jnp.mean(obs[:, :, 1] ** 2)

    p_j = {"kp": jnp.asarray(0.6), "b": jnp.asarray(0.75)}
    g_j = jax.grad(j_loss)(p_j)
    p_t = {k: torch.tensor(float(v), dtype=torch.float64, requires_grad=True) for k, v in p_j.items()}
    z = torch.zeros((), dtype=torch.float64)
    kp, bias = p_t["kp"], p_t["b"]
    params = torch.stack([-kp, z, z, z, kp, z, -kp, z, z, z, bias, 0.9 * bias])
    policy = P.AffinePolicy(np.zeros((2, 5)))
    obs, acts, _ = pe.fused_closed_loop(ps, policy, T, obs_stride=1, policy_params=params)
    u = (acts + 1) / 2 * 650.0 - 325.0
    assert 0 < int((u.pow(2).sum(-1).sqrt() > 400.0 / math.sqrt(3.0)).sum()) < n * T  # binds on part
    (torch.mean((obs[:, :, 0] - obs[:, :, 4]) ** 2) + torch.mean(obs[:, :, 1] ** 2)).backward()
    for k in p_j:
        _close_param(float(p_t[k].grad), float(g_j[k]))


def test_stateful_policy_gradient_matches_jax():
    """test_stateful_policy_gradient_through_closed_loop_kernel: PI gains and
    the initial integrator, with the loss touching the trajectory, the
    actions and the final carry."""
    _check_stateful_law("callable")


def test_stateful_affine_policy_gradient_matches_jax():
    """The same PI law as an ``AffinePolicy`` with ``Ki`` whose gains
    autograd builds from ``{kp, ki}`` (the carry ``c + ki e``, then ``a = kp
    e - 0.2 omega + c``), through the closed loop's VJP."""
    _check_stateful_law("AffinePolicy")


def _check_stateful_law(family):
    n, T = 64, 8
    rng = np.random.default_rng(61)
    x0 = {"theta": rng.uniform(-1, 1, n), "omega": rng.uniform(-1, 1, n)}
    refs = {"theta": np.linspace(-1.0, 1.0, n)}
    je = J.Pendulum(batch_size=n, control_state=["theta"])
    pe = P.Pendulum(batch_size=n, control_state=["theta"], **F64)
    js, ps = _jax_state(je, x0, refs), state_from_numpy(pe, x0, reference=refs)

    def law(obs, t, carry, p):
        e = obs[2] - obs[0]
        integ = carry[0] + p["ki"] * e
        return (p["kp"] * e + integ - 0.2 * obs[1],), (integ,)

    def j_loss(p, c0):
        obs, acts, _, _, fc = j_tile_policy_scan(je, js, T, law, p, True, policy_carry=c0)
        return (jnp.mean((obs[:, :, 0] - obs[:, :, 2]) ** 2) + 1e-3 * jnp.mean(acts ** 2)
                + 1e-4 * jnp.mean(fc[0] ** 2))

    c0 = 0.01 * np.linspace(-1.0, 1.0, n)
    p_j = {"kp": jnp.asarray(0.7), "ki": jnp.asarray(0.08)}
    g_jp, g_jc = jax.grad(j_loss, argnums=(0, 1))(p_j, (jnp.asarray(c0),))
    p_t = {k: torch.tensor(float(v), dtype=torch.float64, requires_grad=True) for k, v in p_j.items()}
    c_t = _leaf(c0)
    if family == "callable":
        policy, params = law, p_t
    else:
        policy = P.AffinePolicy(np.zeros((1, 3)), Ki=np.zeros((1, 3)))
        z = torch.zeros((), dtype=torch.float64)
        kp, ki = p_t["kp"], p_t["ki"]
        params = torch.stack([-kp, z - 0.2, kp, z, -ki, z, ki])
    obs, acts, _, fc = pe.fused_closed_loop(ps, policy, T, obs_stride=1, policy_params=params, policy_carry=(c_t,))
    loss = (torch.mean((obs[:, :, 0] - obs[:, :, 2]) ** 2) + 1e-3 * torch.mean(acts ** 2)
            + 1e-4 * torch.mean(fc[0] ** 2))
    loss.backward()
    for k in p_j:
        _close_param(float(p_t[k].grad), float(g_jp[k]))
    np.testing.assert_allclose(c_t.grad.numpy(), np.asarray(g_jc[0]), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("family", ["callable", "AffinePolicy"])
def test_pmsm_policy_gradient_matches_jax(family):
    """test_pmsm_policy_gradient_through_closed_loop_kernel: the cross-term
    law on saturated BRUSA against the scan of ``env.step`` (which takes
    the sector from ``atan2``), 1e-9 relative per parameter."""
    n, T = 32, 8
    je = J.PMSM(batch_size=n, saturated=True, motor_variant=J.MotorVariant.BRUSA, control_state=["i_d", "i_q"])
    pe = P.PMSM(batch_size=n, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"],
                **F64)
    rng = np.random.default_rng(62)
    norms = pe.env_properties.physical_normalizations
    x0 = {"u_d_buffer": rng.uniform(-50, 50, n), "u_q_buffer": rng.uniform(-50, 50, n),
          "epsilon": rng.uniform(-math.pi, math.pi, n), "i_d": rng.uniform(-150, 0, n),
          "i_q": rng.uniform(-150, 150, n), "omega_el": rng.uniform(0, 0.5 * norms.omega_el.max, n)}
    x0["torque"] = pe._torque(_t(x0["i_d"]), _t(x0["i_q"]), pe.env_properties).numpy()
    refs = {"i_d": np.linspace(-200.0, -10.0, n), "i_q": np.linspace(-150.0, 150.0, n)}
    js, ps = _jax_state(je, x0, refs), state_from_numpy(pe, x0, reference=refs)

    def law(obs, t, p):
        return (-p["kd"] * (obs[0] - obs[8]) - p["kx"] * obs[1], -p["kq"] * (obs[1] - obs[9]) + p["kx"] * obs[0])

    def j_loss(p):
        obs = j_tile_policy_scan(je, js, T, law, p, True)[0]
        return jnp.mean((obs[:, :, 0] - obs[:, :, 8]) ** 2 + (obs[:, :, 1] - obs[:, :, 9]) ** 2)

    p_j = {"kd": jnp.asarray(0.6), "kq": jnp.asarray(0.6), "kx": jnp.asarray(0.05)}
    g_j = jax.grad(j_loss)(p_j)
    p_t = {k: torch.tensor(float(v), dtype=torch.float64, requires_grad=True) for k, v in p_j.items()}
    if family == "callable":
        policy, params = law, p_t
    else:
        policy = P.AffinePolicy(np.zeros((2, 10)))
        z = torch.zeros((), dtype=torch.float64)
        row_d = [-p_t["kd"], -p_t["kx"]] + [z] * 6 + [p_t["kd"], z]
        row_q = [p_t["kx"], -p_t["kq"]] + [z] * 7 + [p_t["kq"]]
        params = torch.cat([torch.stack(row_d + row_q), torch.zeros(2, dtype=torch.float64)])
    obs, _, _ = pe.fused_closed_loop(ps, policy, T, obs_stride=1, policy_params=params)
    torch.mean((obs[:, :, 0] - obs[:, :, 8]) ** 2 + (obs[:, :, 1] - obs[:, :, 9]) ** 2).backward()
    for k in p_j:
        _close_param(float(p_t[k].grad), float(g_j[k]))


def test_fused_rollout_grad_matches_jax_scan():
    """test_fused_rollout_grad_matches_scan: CartPole Tsit5, the gradient of
    the final observation's square sum in the action slab and the initial
    state."""
    n, T = 32, 8
    je, pe = J.CartPole(batch_size=n, solver="tsit5"), P.CartPole(batch_size=n, solver="tsit5", **F64)
    rng = np.random.default_rng(63)
    x0 = {f: rng.uniform(-1, 1, n) for f in pe._ode_state_fields}
    acts = rng.uniform(-0.7, 0.7, (n, T, 1))
    js = _jax_state(je, x0)

    def j_loss(a, x):
        with jstructures.copy_and_mutate(js) as st:
            for f, v in x.items():
                setattr(st.physical_state, f, v)
        return jnp.sum(je.vmap_rollout(st, a, T)[0][:, -1] ** 2)

    g_ja, g_jx = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(acts), {f: jnp.asarray(v) for f, v in x0.items()})
    x_t = {f: _leaf(v) for f, v in x0.items()}
    ps = state_from_numpy(pe, x0)
    for f, leaf in x_t.items():
        setattr(ps.physical_state, f, leaf)
    a_t = _leaf(acts)
    obs, _ = pe.fused_rollout(ps, a_t, strict=True)
    (obs ** 2).sum().backward()
    np.testing.assert_allclose(a_t.grad.numpy(), np.asarray(g_ja), rtol=1e-9, atol=1e-12)
    for f in x0:
        np.testing.assert_allclose(x_t[f].grad.numpy(), np.asarray(g_jx[f]), rtol=1e-9, atol=1e-12)


def test_per_batch_param_grad_matches_jax():
    """test_fused_per_batch_param_grad: the gradient in per-batch pendulum
    lengths, against ``jax.grad`` of a scan of ``env.step`` with the lengths
    as the differentiated leaf."""
    n, T = 32, 8
    lengths = 1.0 + np.arange(n) / n
    je = J.Pendulum(batch_size=n, static_params={"l": jnp.asarray(lengths), "g": 9.81, "m": 1})
    pe = P.Pendulum(batch_size=n, static_params={"l": lengths, "g": 9.81, "m": 1}, **F64)
    rng = np.random.default_rng(64)
    x0 = {"theta": rng.uniform(-1, 1, n), "omega": rng.uniform(-1, 1, n)}
    acts = rng.uniform(-0.9, 0.9, (n, T, 1))
    js = _jax_state(je, x0)
    step_b = jax.vmap(je.step, in_axes=(0, 0, je.in_axes_env_properties))

    def j_loss(l_leaf):
        props = jstructures.replace(je.env_properties, static_params=jstructures.replace(
            je.env_properties.static_params, l=l_leaf))

        def body(st, a):
            obs, st = step_b(st, a, props)
            return st, None

        st, _ = jax.lax.scan(body, js, jnp.swapaxes(jnp.asarray(acts), 0, 1))
        return jnp.sum(st.physical_state.omega ** 2)

    g_j = jax.grad(j_loss)(jnp.asarray(lengths))
    l_t = _leaf(lengths)
    pe.env_properties.static_params.l = l_t
    _, last = pe.fused_rollout(state_from_numpy(pe, x0), _t(acts), strict=True)
    (last.physical_state.omega ** 2).sum().backward()
    np.testing.assert_allclose(l_t.grad.numpy(), np.asarray(g_j), rtol=1e-9, atol=1e-12)


def test_pmsm_fused_grad_matches_jax_scan():
    """test_pmsm_fused_grad_matches_scan: saturated BRUSA, the gradient of
    the final observation's square sum in the normalized action slab."""
    n, T = 32, 4
    je = J.PMSM(batch_size=n, saturated=True, motor_variant=J.MotorVariant.BRUSA)
    pe = P.PMSM(batch_size=n, saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
    rng = np.random.default_rng(65)
    norms = pe.env_properties.physical_normalizations
    x0 = {"u_d_buffer": rng.uniform(-50, 50, n), "u_q_buffer": rng.uniform(-50, 50, n),
          "epsilon": rng.uniform(-math.pi, math.pi, n), "i_d": rng.uniform(-150, 0, n),
          "i_q": rng.uniform(-150, 150, n), "omega_el": rng.uniform(0, 0.5 * norms.omega_el.max, n)}
    x0["torque"] = pe._torque(_t(x0["i_d"]), _t(x0["i_q"]), pe.env_properties).numpy()
    acts = rng.uniform(-0.4, 0.4, (n, T, 2))
    js = _jax_state(je, x0)
    g_j = jax.grad(lambda a: jnp.sum(je.vmap_rollout(js, a, T)[0][:, -1] ** 2))(jnp.asarray(acts))
    a_t = _leaf(acts)
    obs, _ = pe.fused_rollout(state_from_numpy(pe, x0), a_t, strict=True)
    (obs ** 2).sum().backward()
    np.testing.assert_allclose(a_t.grad.numpy(), np.asarray(g_j), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("hold", [1, 2])
def test_fused_sim_ahead_fsal_grad_matches_jax(hold):
    """test_fused_sim_ahead_fsal_grad_matches_scan: Pendulum Tsit5 in
    sim-ahead mode, whose ``c == 1`` stages read the next action row, so the
    backward un-shifts that row's cotangent; gradients of the trajectory's
    square sum in the action slab and the initial state against
    ``jax.grad`` of the JAX package's ``vmap_sim_ahead`` (``hold`` solver
    steps per action row)."""
    n, T = 32, 6
    je, pe = J.Pendulum(batch_size=n, solver="tsit5"), P.Pendulum(batch_size=n, solver="tsit5", **F64)
    rng = np.random.default_rng(66 + hold)
    x0 = {f: rng.uniform(-1, 1, n) for f in pe._ode_state_fields}
    acts = rng.uniform(-0.7, 0.7, (n, T, 1))
    js = _jax_state(je, x0)

    def j_loss(a, x):
        with jstructures.copy_and_mutate(js) as st:
            for f, v in x.items():
                setattr(st.physical_state, f, v)
        return jnp.sum(je.vmap_sim_ahead(st, a, je.tau, hold * je.tau)[0] ** 2)

    g_ja, g_jx = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(acts), {f: jnp.asarray(v) for f, v in x0.items()})
    x_t = {f: _leaf(v) for f, v in x0.items()}
    ps = state_from_numpy(pe, x0)
    for f, leaf in x_t.items():
        setattr(ps.physical_state, f, leaf)
    a_t = _leaf(acts)
    obs, _ = pe.fused_sim_ahead(ps, a_t, pe.tau, hold * pe.tau, strict=True)
    (obs ** 2).sum().backward()
    assert float(a_t.grad[:, -1].abs().max()) > 0  # the last row reaches the loss only as a next action
    np.testing.assert_allclose(a_t.grad.numpy(), np.asarray(g_ja), rtol=1e-9, atol=1e-12)
    for f in x0:
        np.testing.assert_allclose(x_t[f].grad.numpy(), np.asarray(g_jx[f]), rtol=1e-9, atol=1e-12)


def test_pmsm_fused_sim_ahead_fsal_grad_matches_jax():
    """test_pmsm_fused_sim_ahead_fsal_grad_matches_scan: saturated BRUSA,
    Tsit5 in sim-ahead mode, the gradient of the trajectory's square sum in
    the normalized action slab (through the hexagon and the next-voltage
    un-shift) against ``jax.grad`` of the JAX package's ``vmap_sim_ahead``.
    Without deadtime, the case taken here, a segment boundary's constrained
    voltage is both the last step's and the next one's; deadtime 1 runs the
    same hexagon and is held against autograd through the plain loop
    above."""
    n, T = 32, 5
    params = dict(J.MotorVariant.BRUSA.get_params().static_params.__dict__)
    params.update(l_d=math.nan, l_q=math.nan, psi_p=math.nan, deadtime=0)
    je = J.PMSM(batch_size=n, saturated=True, motor_variant=J.MotorVariant.BRUSA, solver="tsit5",
                static_params=params)
    pe = P.PMSM(batch_size=n, saturated=True, motor_variant=P.MotorVariant.BRUSA, solver="tsit5",
                static_params=params, **F64)
    rng = np.random.default_rng(68)
    norms = pe.env_properties.physical_normalizations
    x0 = {"u_d_buffer": rng.uniform(-50, 50, n), "u_q_buffer": rng.uniform(-50, 50, n),
          "epsilon": rng.uniform(-math.pi, math.pi, n), "i_d": rng.uniform(-150, 0, n),
          "i_q": rng.uniform(-150, 150, n), "omega_el": rng.uniform(0, 0.5 * norms.omega_el.max, n)}
    x0["torque"] = pe._torque(_t(x0["i_d"]), _t(x0["i_q"]), pe.env_properties).numpy()
    acts = rng.uniform(-0.6, 0.6, (n, T, 2))
    js = _jax_state(je, x0)
    g_j = jax.grad(lambda a: jnp.sum(je.vmap_sim_ahead(js, a, je.tau, je.tau)[0] ** 2))(jnp.asarray(acts))
    a_t = _leaf(acts)
    obs, _ = pe.fused_sim_ahead(state_from_numpy(pe, x0), a_t, pe.tau, pe.tau, strict=True)
    (obs ** 2).sum().backward()
    assert float(a_t.grad[:, -1].abs().max()) > 0
    np.testing.assert_allclose(a_t.grad.numpy(), np.asarray(g_j), rtol=1e-9, atol=1e-12)


def test_actor_gradient_matches_jax():
    """test_mlp_policy_in_kernel_grad_matches_scan with the port's compiled
    MLP: the deterministic (16, 16) actor of ``make_actor_tile``, its weight
    tree carried across with ``actor_params_from_numpy``; the gradient of a
    loss over the observations and the actions in every weight and bias
    (through the flat ``KernelSpec`` vector and its views) against
    ``jax.grad`` of the JAX package's ``tile_policy_scan``.  As in the
    reference's spec, the JAX side's MLP is written with matrix products
    (tanh between layers, linear head, the deterministic actor's clamp):
    the JAX package's unrolled tile computes the same function, and is held
    against the port's actor in tests/test_torch_rl_fused.py."""
    n, T = 32, 6
    rng = np.random.default_rng(70)
    x0 = {"theta": rng.uniform(-1, 1, n), "omega": rng.uniform(-1, 1, n)}
    refs = {"theta": np.linspace(-1.0, 1.0, n)}
    je = J.Pendulum(batch_size=n, control_state=["theta"])
    pe = P.Pendulum(batch_size=n, control_state=["theta"], **F64)
    js, ps = _jax_state(je, x0, refs), state_from_numpy(pe, x0, reference=refs)
    tree = _actor_tree(3, rng)

    def j_tile(obs, t, carry, actor):
        h = jnp.stack(obs, -1)
        for i, layer in enumerate(actor):
            h = h @ layer["w"] + layer["b"]
            h = jnp.tanh(h) if i < len(actor) - 1 else jnp.clip(h, -1.0, 1.0)
        return tuple(h[:, j] for j in range(h.shape[1])), carry

    def j_loss(actor):
        obs, acts = j_tile_policy_scan(je, js, T, j_tile, actor, True, policy_carry=(jnp.zeros(n),))[:2]
        return jnp.mean((obs[:, :, 0] - obs[:, :, 2]) ** 2) + 1e-2 * jnp.mean(acts ** 2)

    g_j = jax.grad(j_loss)([{k: jnp.asarray(v) for k, v in layer.items()} for layer in tree["actor"]])
    params = actor_params_from_numpy(pe, tree)
    for layer in params["actor"]:
        for leaf in layer.values():
            leaf.requires_grad_(True)
    tile, c0 = P.make_actor_tile(pe, deterministic=True)
    obs, acts, _, _ = pe.fused_closed_loop(ps, tile, T, obs_stride=1, policy_params=params, policy_carry=c0)
    (torch.mean((obs[:, :, 0] - obs[:, :, 2]) ** 2) + 1e-2 * torch.mean(acts ** 2)).backward()
    for layer_t, layer_j in zip(params["actor"], g_j):
        for k in ("w", "b"):
            assert float(layer_t[k].grad.abs().max()) > 0
            np.testing.assert_allclose(layer_t[k].grad.numpy(), np.asarray(layer_j[k]), rtol=1e-9, atol=1e-12)
