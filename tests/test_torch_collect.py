"""The port's open-loop and policy collectors (``utils/collect.py``) against
the JAX package's ``RolloutCollector``: the counterparts of
tests/test_signals_and_collect.py:40-158, on CPU tensors in float64.

Tolerances: ``collect`` and ``collect_policy`` follow the JAX collectors at
rtol = atol = 1e-12 (XLA's CPU contracts multiply-adds, PyTorch does not).
``collect_fused`` (on CPU tensors the kernels' plain versions) equals the
port's ``collect`` exactly where the arithmetic is the same (``torch.equal``
on observations, flags and final keys; physical leaves at 1e-12) and
follows the JAX ``collect_fused(..., interpret=True)`` (the Pallas kernels
in interpret mode) at 1e-10, the JAX test's tolerance, in every noise mode
and on a randomized saturated BRUSA fleet (B = 1,024, the JAX drive
kernel's batch multiple), whose state is carried across from the JAX
package's keyed reset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_torch as P
import exciting_environments_tpu as J
from exciting_environments_torch.core import structures
from exciting_environments_torch.ops import random as R
from exciting_environments_torch.ops.kernels import rollout_path
from exciting_environments_torch.utils import MinMaxNormalization
from exciting_environments_torch.utils import randomize as PR
from exciting_environments_torch.utils.collect import RolloutCollector
from exciting_environments_torch.utils.convert import state_from_numpy
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.utils import randomize as JR
from exciting_environments_tpu.utils.collect import RolloutCollector as JRolloutCollector

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-12, atol=1e-12)
FUSED_TOL = dict(rtol=1e-10, atol=1e-10)
LEAVES = ("observations", "actions", "rewards", "terminated", "truncated")
PMSM_FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")


def _keys(seed, n):
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.as_tensor(np.asarray(jk).astype(np.int64))


def _close(batch, jbatch, tol):
    for name in LEAVES:
        a, b = getattr(batch, name), np.asarray(getattr(jbatch, name))
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy().astype(np.float64), b.astype(np.float64), err_msg=name, **tol)


def _equal(batch, other):
    for name in LEAVES:
        assert torch.equal(getattr(batch, name), getattr(other, name)), name


def _pendulum(batch, seed=0, **kw):
    """The JAX and port pendulums, reset from the same keys, tracking a
    reference spread over the batch."""
    je = J.Pendulum(batch_size=batch, control_state=["theta"], **kw)
    pe = P.Pendulum(batch_size=batch, control_state=["theta"], **kw, **F64)
    jk, tk = _keys(seed, batch)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(tk)
    ref = np.linspace(-1.0, 1.0, batch)
    js = jstructures.replace(js, reference=jstructures.replace(js.reference, theta=jnp.asarray(ref)))
    ps = structures.replace(ps, reference=structures.replace(ps.reference, theta=torch.as_tensor(ref)))
    return je, pe, js, ps


def _actions(seed, shape, lim):
    a = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=-lim, maxval=lim))
    return jnp.asarray(a), torch.as_tensor(a.copy())


def test_collect_matches_jax_and_the_manual_loop():
    je, pe, js, ps = _pendulum(64)
    ja, ta = _actions(1, (64, 6, 1), 0.8)
    batch, final = RolloutCollector(pe).collect(ps, ta)
    jbatch, jfinal = JRolloutCollector(je).collect(js, ja)
    assert batch.observations.shape == (64, 6, 3) and batch.rewards.shape == (64, 6, 1)
    _close(batch, jbatch, TOL)
    np.testing.assert_allclose(final.physical_state.theta.numpy(), np.asarray(jfinal.physical_state.theta), **TOL)
    s = ps
    for t in range(6):
        obs, s = pe.vmap_step(s, ta[:, t])
    assert torch.equal(batch.observations[:, -1], obs)
    assert torch.equal(final.physical_state.omega, s.physical_state.omega)


@pytest.mark.parametrize("noise", [None, "exact", "fast"])
def test_collect_fused_matches_collect_and_jax(noise):
    """The kernel path's plain version equals the eager collector, and
    follows JAX ``collect_fused`` in interpret mode, in both noise modes:
    fast mode's ``collect`` consumes the time-parallel slab the kernel
    takes (``_collect_fast_noise``)."""
    kw = {} if noise is None else dict(process_noise={"omega": 0.3}, observation_noise={"theta": 0.02},
                                       noise_mode=noise)
    je, pe, js, ps = _pendulum(1024, **kw)
    assert rollout_path(pe) == "fused"
    ja, ta = _actions(1, (1024, 6, 1), 0.5)
    col = RolloutCollector(pe)
    batch_s, final_s = col.collect(ps, ta)
    batch_f, final_f = col.collect_fused(ps, ta)
    _equal(batch_f, batch_s)
    assert torch.equal(final_f.PRNGKey, final_s.PRNGKey)
    for name in ("theta", "omega"):
        np.testing.assert_allclose(getattr(final_f.physical_state, name).numpy(),
                                   getattr(final_s.physical_state, name).numpy(), **TOL)
    jbatch, jfinal = JRolloutCollector(je).collect_fused(js, ja, interpret=True)
    _close(batch_f, jbatch, FUSED_TOL)
    np.testing.assert_allclose(final_f.physical_state.theta.numpy(), np.asarray(jfinal.physical_state.theta),
                               **FUSED_TOL)
    if noise is not None:
        np.testing.assert_array_equal(final_f.PRNGKey.numpy(), np.asarray(jfinal.PRNGKey).astype(np.int64))


def test_collect_fused_out_of_scope_is_collect():
    """An implicit solver is outside the kernels' scope: collect_fused is
    then the eager collector, with its batch."""
    env = P.MassSpringDamper(batch_size=8, solver="implicit_euler", tau=1e-2, **F64)
    assert rollout_path(env) == "scan"
    _, st = env.vmap_reset(R.split(R.PRNGKey(0, "cpu"), 8))
    acts = torch.full((8, 4, 1), 0.2, dtype=torch.float64)
    col = RolloutCollector(env)
    batch_s, final_s = col.collect(st, acts)
    batch_f, final_f = col.collect_fused(st, acts)
    _equal(batch_f, batch_s)
    assert torch.equal(final_f.physical_state.deflection, final_s.physical_state.deflection)


def test_collect_fused_randomized_brusa_fleet_matches_jax():
    """A randomized saturated BRUSA fleet (per-batch ``r_s``) through the
    PMSM kernel's plain version, against the JAX drive kernel in interpret
    mode, the JAX package's keyed reset carried across."""
    B, T = 1024, 8
    defaults = dict(J.MotorVariant.BRUSA.get_params().static_params.__dict__)
    jkey = jax.random.PRNGKey(7)
    jenv = JR.randomize_env(J.PMSM, jkey, {"r_s": JR.Uniform(15e-3, 21e-3)}, batch_size=B, defaults=defaults,
                            saturated=True, motor_variant=J.MotorVariant.BRUSA, control_state=["i_d", "i_q"])
    env = PR.randomize_env(P.PMSM, torch.as_tensor(np.asarray(jkey).astype(np.int64)),
                           {"r_s": PR.Uniform(15e-3, 21e-3)}, batch_size=B, defaults=defaults, saturated=True,
                           motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"], **F64)
    np.testing.assert_array_equal(env.env_properties.static_params.r_s.numpy(),
                                  np.asarray(jenv.env_properties.static_params.r_s))
    assert rollout_path(env) == "pmsm_fused"
    jk, _ = _keys(1, B)
    _, js = jenv.vmap_reset(jk)
    refs = {"i_d": np.linspace(-200.0, -10.0, B), "i_q": np.linspace(-150.0, 150.0, B)}
    js = jstructures.replace(js, reference=jstructures.replace(
        js.reference, **{k: jnp.asarray(v) for k, v in refs.items()}))
    ps = state_from_numpy(env, {n: np.asarray(getattr(js.physical_state, n)) for n in PMSM_FIELDS}, reference=refs,
                          keys=np.asarray(js.PRNGKey))
    ja, ta = _actions(2, (B, T, 2), 0.4)
    batch, final = RolloutCollector(env).collect_fused(ps, ta)
    jbatch, jfinal = JRolloutCollector(jenv).collect_fused(js, ja, interpret=True)
    _close(batch, jbatch, FUSED_TOL)
    for name in ("i_d", "i_q", "torque", "epsilon", "u_d_buffer"):
        np.testing.assert_allclose(getattr(final.physical_state, name).numpy(),
                                   np.asarray(getattr(jfinal.physical_state, name)), err_msg=name, **FUSED_TOL)
    batch_s, _ = RolloutCollector(env).collect(ps, ta)
    _close(batch_s, jbatch, FUSED_TOL)


def test_collect_policy_matches_jax():
    """Gaussian exploration around a PD law, drawing from each step's key
    (``split(rng, n_steps)``)."""
    je, pe, js, ps = _pendulum(64)
    jrng = jax.random.PRNGKey(5)
    rng = torch.as_tensor(np.asarray(jrng).astype(np.int64))

    def jpolicy(obs, key):
        u = -0.7 * (obs[:, :1] - obs[:, 2:3]) - 0.2 * obs[:, 1:2]
        return jnp.clip(u + 0.1 * jax.random.normal(key, u.shape), -1.0, 1.0)

    def policy(obs, key):
        u = -0.7 * (obs[:, :1] - obs[:, 2:3]) - 0.2 * obs[:, 1:2]
        return torch.clamp(u + 0.1 * R.normal(key, tuple(u.shape), torch.float64), -1.0, 1.0)

    batch, final = RolloutCollector(pe).collect_policy(policy, ps, rng, 12)
    jbatch, jfinal = JRolloutCollector(je).collect_policy(jpolicy, js, jrng, 12)
    assert batch.observations.shape == (64, 12, 3) and batch.actions.shape == (64, 12, 1)
    _close(batch, jbatch, TOL)
    np.testing.assert_allclose(final.physical_state.theta.numpy(), np.asarray(jfinal.physical_state.theta), **TOL)
    assert bool(torch.isfinite(batch.observations).all())
    # the exploration noise is there: another key gives other actions
    other, _ = RolloutCollector(pe).collect_policy(policy, ps, R.PRNGKey(6, "cpu"), 12)
    assert not torch.equal(other.actions, batch.actions)
    assert float(batch.actions.abs().max()) <= 1.0


def _brusa_config(batch=16, cls=P.PMSM, **overrides):
    """The benchmark's ``pmsm_brusa`` configuration (``portbench/configs``)
    at a small batch on the CPU, with per-drive ``r_s`` as its cell draws
    it; ``overrides`` go to the constructor."""
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).parents[1] / "portbench" / "configs" / "pmsm_brusa.json").read_text())
    kw = dict(cfg["kwargs"], motor_variant=P.MotorVariant[cfg["kwargs"]["motor_variant"]])
    params = {**vars(P.MotorVariant.BRUSA.get_params().static_params), **cfg["static_params"],
              "r_s": torch.linspace(0.015, 0.021, batch, dtype=torch.float32)}
    return cls(batch_size=batch, device="cpu", dtype=getattr(torch, cfg["dtype"]),
                  **{**kw, "static_params": params, **overrides})


def test_the_benchmark_configuration_is_inside_the_collect_epilogue():
    """The benchmark's drive is inside the epilogue's scope; on CPU tensors
    a collection still does not engage it."""
    from exciting_environments_torch.ops.kernels import pmsm_stepper as PK

    env = _brusa_config()
    assert PK.supports_collect_epilogue(env)
    _, st = env.vmap_reset()
    assert not PK.collect_epilogue_engages(env, st, torch.zeros((16, 4, 2)))


class _OwnReward(P.PMSM):
    def generate_reward(self, state, action, env_properties):
        return 2 * super().generate_reward(state, action, env_properties)


class _OwnNormalization(MinMaxNormalization):
    def normalize(self, denormalized_value):
        return super().normalize(denormalized_value) * 0.5


def _out_of_epilogue(case):
    from exciting_environments_torch.parallel.mesh import ShardedEnv, make_batch_mesh

    if case == "pendulum":
        return P.Pendulum(batch_size=16, control_state=["theta"], device="cpu", dtype=torch.float32)
    if case == "sharded":
        return ShardedEnv(_brusa_config(), make_batch_mesh(["cpu"] * 2))
    if case == "own_reward":
        return _brusa_config(cls=_OwnReward)
    if case == "own_observation":
        env = _brusa_config()
        env.generate_observation = lambda state, props: P.PMSM.generate_observation(env, state, props)
        return env
    if case == "own_normalization":
        norms = dict(vars(P.MotorVariant.BRUSA.get_params().physical_normalizations))
        norms["torque"] = _OwnNormalization(min=-200, max=200)
        return _brusa_config(physical_normalizations=norms)
    overrides = {"torque_reward": dict(control_state=["torque"]),
                 "both_rewards": dict(control_state=["i_d", "i_q", "torque"]),
                 "swapped_references": dict(control_state=["i_q", "i_d"]),
                 "observation_noise": dict(observation_noise={"i_d": 0.01}),
                 "deadtime_2": dict(static_params={**vars(P.MotorVariant.BRUSA.get_params().static_params),
                                                   "deadtime": 2})}[case]
    return _brusa_config(**overrides)


@pytest.mark.parametrize("case", ["pendulum", "sharded", "own_reward", "own_observation", "own_normalization",
                                  "torque_reward", "both_rewards", "swapped_references", "observation_noise",
                                  "deadtime_2"])
def test_collect_epilogue_scope_excludes(case):
    """Outside the epilogue's scope: another environment, a batch split,
    another reward, observation or normalization, another ``control_state``,
    observation noise, or a drive outside the kernel's own scope."""
    from exciting_environments_torch.ops.kernels import pmsm_stepper as PK

    assert not PK.supports_collect_epilogue(_out_of_epilogue(case))


def test_observation_bands_take_scalars_and_batch_leaves():
    """The epilogue's bands: Python numbers for scalar leaves, the ``(B,)``
    tensor of a per-drive one, in :data:`OBS_FIELDS` order."""
    from exciting_environments_torch.ops.kernels import pmsm_stepper as PK

    norms = dict(vars(P.MotorVariant.BRUSA.get_params().physical_normalizations))
    i_d_min = torch.linspace(-250.0, -220.0, 16)
    norms["i_d"] = MinMaxNormalization(min=i_d_min, max=0)
    env = _brusa_config(physical_normalizations=norms)
    bands = PK.observation_bands(env.env_properties, 16)
    assert len(bands) == 2 * len(PK.OBS_FIELDS) and torch.equal(bands[0], i_d_min)
    assert bands[1:4] == [0.0, -250.0, 250.0] and all(isinstance(b, float) for b in bands[1:])
    assert PK.supports_collect_epilogue(env)


@pytest.mark.parametrize("saturated", [True, False])
def test_collect_fused_on_cpu_takes_the_eager_rebuild(saturated):
    """On CPU tensors ``collect_fused`` rebuilds from the plain version's
    states, counted under ``"eager"``, and equals ``collect``."""
    from exciting_environments_torch.ops.kernels import pmsm_stepper as PK

    env = _brusa_config(batch=8, saturated=saturated)
    assert PK.supports_collect_epilogue(env)
    _, st = env.vmap_reset(R.split(R.PRNGKey(3, "cpu"), 8))
    st.reference.i_d = torch.linspace(-200.0, -10.0, 8)
    st.reference.i_q = torch.linspace(-150.0, 150.0, 8)
    acts = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (8, 5, 2)), dtype=torch.float32)
    col = RolloutCollector(env)
    paths = dict(PK.COLLECT_PATHS)
    batch_f, final_f = col.collect_fused(st, acts)
    assert PK.COLLECT_PATHS == {"epilogue": paths["epilogue"], "eager": paths["eager"] + 1}
    batch_s, final_s = col.collect(st, acts)
    _equal(batch_f, batch_s)
    assert batch_f.observations.shape == (8, 5, 10) and batch_f.rewards.shape == (8, 5, 1)
    for name in ("i_d", "i_q", "epsilon", "u_d_buffer", "u_q_buffer"):
        assert torch.equal(getattr(final_f.physical_state, name), getattr(final_s.physical_state, name)), name
