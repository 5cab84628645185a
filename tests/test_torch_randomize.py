"""Domain randomization in the port (``utils/randomize.py``) against the JAX
package's, from the same threefry key: the counterparts of
tests/test_randomize.py, on CPU tensors.

Tolerances: ``Uniform`` (and the plain tuple) and ``Choice`` fleets bit for
bit with JAX, in float64 (conftest's ``jax_enable_x64``) and float32
(inside ``jax.enable_x64(False)``).  ``LogUniform`` draws the same uniforms;
its ``exp`` is within 2 ulps of XLA's in float64 and 1 ulp in float32 (XLA
evaluates its own polynomial for ``exp`` on the CPU, 1 ulp from the
correctly rounded value in about 14% of float64 draws).  ``Normal`` is
within the normals' 5e-14 abs in float64 and 1e-5 in float32
(``erfinv``'s last bits, tests/test_torch_random.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_torch as P
import exciting_environments_tpu as J
from exciting_environments_torch.ops import random as R
from exciting_environments_torch.ops.kernels import rollout_path
from exciting_environments_torch.utils import randomize as PR
from exciting_environments_tpu.utils import randomize as JR

JKEY = jax.random.PRNGKey(7)
KEY = torch.as_tensor(np.asarray(JKEY).astype(np.int64))
B = 256
F64 = dict(device="cpu", dtype=torch.float64)
NORMAL_ATOL = {torch.float64: 5e-14, torch.float32: 1e-5}


def _pair(name, *args, **kwargs):
    return getattr(JR, name)(*args, **kwargs), getattr(PR, name)(*args, **kwargs)


SPECS = {
    "uniform": lambda: _pair("Uniform", 0.5, 2.0),
    "tuple": lambda: ((15e-3, 21e-3), (15e-3, 21e-3)),
    "loguniform": lambda: _pair("LogUniform", 1e-3, 1e1),
    "normal": lambda: _pair("Normal", 1.0, 0.3, clip=(0.5, 1.5)),
    "choice": lambda: _pair("Choice", (1.0, 2.0, 4.0)),
    "choice_p": lambda: _pair("Choice", (1.0, 2.0, 4.0), (0.2, 0.5, 0.3)),
}


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("x64", [True, False], ids=["float64", "float32"])
def test_fleet_draws_match_jax(spec, x64):
    dtype = torch.float64 if x64 else torch.float32
    js, ps = SPECS[spec]()
    defaults = {"g": 9.81, "l": 2.0, "m": 1.0}
    with jax.enable_x64(x64):
        want = JR.sample_static_params(JKEY, 4096, {"l": js, "m": (0.1, 0.2)}, defaults)
        want = {k: np.asarray(v) for k, v in want.items()}
    got = PR.sample_static_params(KEY, 4096, {"l": ps, "m": (0.1, 0.2)}, defaults, dtype=dtype)
    assert got["g"] == 9.81 and got["l"].dtype == dtype
    np.testing.assert_array_equal(got["m"].numpy(), want["m"])
    if spec == "loguniform":
        np.testing.assert_array_max_ulp(got["l"].numpy(), want["l"], maxulp=2 if x64 else 1)
    elif spec == "normal":
        np.testing.assert_allclose(got["l"].numpy(), want["l"], rtol=0, atol=NORMAL_ATOL[dtype])
    else:
        np.testing.assert_array_equal(got["l"].numpy(), want["l"])


def test_distribution_supports():
    u = PR.sample_field(KEY, B, PR.Uniform(0.5, 2.0))
    assert u.shape == (B,) and float(u.min()) >= 0.5 and float(u.max()) < 2.0
    lu = PR.sample_field(KEY, B, PR.LogUniform(1e-3, 1e1), torch.float64)
    assert float(lu.min()) >= 1e-3 and float(lu.max()) < 1e1
    # log-uniform spans the decades (a linear draw would put <0.1% below 1e-2)
    assert float((lu < 1e-2).double().mean()) > 0.1
    n = PR.sample_field(KEY, B, PR.Normal(1.0, 0.3, clip=(0.5, 1.5)))
    assert float(n.min()) >= 0.5 and float(n.max()) <= 1.5
    c = PR.sample_field(KEY, B, PR.Choice((1.0, 2.0, 4.0)))
    assert set(np.unique(c.numpy())) <= {1.0, 2.0, 4.0}
    t = PR.sample_field(KEY, B, (0.0, 1.0))
    assert float(t.min()) >= 0.0 and float(t.max()) < 1.0
    f = PR.sample_field(KEY, B, lambda key, b: torch.full((b,), 3.0))
    assert bool((f == 3.0).all())


def test_invalid_specs():
    with pytest.raises(ValueError):
        PR.LogUniform(0.0, 1.0)
    with pytest.raises(ValueError):
        PR.sample_field(KEY, B, (1.0, 2.0, 3.0))
    with pytest.raises(TypeError):
        PR.sample_field(KEY, B, "uniform")
    with pytest.raises(ValueError):
        PR.sample_field(KEY, B, lambda key, b: torch.zeros((b, 2)))


def test_sampling_is_deterministic_and_per_field_stable():
    spec = {"l": PR.Uniform(0.5, 2.0), "m": PR.LogUniform(0.5, 2.0)}
    defaults = {"g": 9.81, "l": 2.0, "m": 1.0}
    p1 = PR.sample_static_params(KEY, B, spec, defaults)
    p2 = PR.sample_static_params(KEY, B, spec, defaults)
    assert torch.equal(p1["l"], p2["l"]) and p1["g"] == 9.81
    # per-field subkeys are name-keyed: dropping a field leaves the other's
    # draw unchanged, and another key changes it
    p3 = PR.sample_static_params(KEY, B, {"l": PR.Uniform(0.5, 2.0)}, defaults)
    assert torch.equal(p1["l"], p3["l"])
    p4 = PR.sample_static_params(R.PRNGKey(8, "cpu"), B, spec, defaults)
    assert not torch.equal(p1["l"], p4["l"])
    with pytest.raises(ValueError, match="not in defaults"):
        PR.sample_static_params(KEY, B, {"nope": (0.0, 1.0)}, defaults)


def test_randomized_fleet_steps_heterogeneously_and_matches_jax():
    env = PR.randomize_env(P.Pendulum, KEY, {"l": PR.Uniform(0.5, 2.0)}, batch_size=B, **F64)
    jenv = JR.randomize_env(J.Pendulum, JKEY, {"l": JR.Uniform(0.5, 2.0)}, batch_size=B)
    np.testing.assert_array_equal(env.env_properties.static_params.l.numpy(),
                                  np.asarray(jenv.env_properties.static_params.l))
    jk = jax.random.split(JKEY, B)
    _, state = env.vmap_reset(torch.as_tensor(np.asarray(jk).astype(np.int64)))
    _, jstate = jenv.vmap_reset(jk)
    _, state = env.vmap_step(state, torch.full((B, 1), 0.5, dtype=torch.float64))
    _, jstate = jenv.vmap_step(jstate, jnp.full((B, 1), 0.5))
    omega = state.physical_state.omega.numpy()
    assert np.unique(omega).size > B // 2
    np.testing.assert_allclose(omega, np.asarray(jstate.physical_state.omega), rtol=1e-12, atol=1e-12)
    # the registry-id construction path
    env2 = PR.randomize_env("Pendulum-v0", KEY, {"l": PR.Uniform(0.5, 2.0)}, batch_size=B, **F64)
    assert torch.equal(env2.env_properties.static_params.l, env.env_properties.static_params.l)


def test_randomized_fleets_ride_the_kernels():
    env = PR.randomize_env(P.Pendulum, KEY, {"l": (0.5, 2.0)}, batch_size=1024, **F64)
    assert rollout_path(env) == "fused"
    defaults = dict(P.MotorVariant.BRUSA.get_params().static_params.__dict__)
    fleet = PR.randomize_env(P.PMSM, KEY, {"r_s": PR.Uniform(15e-3, 21e-3)}, batch_size=1024, defaults=defaults,
                             saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
    assert fleet.env_properties.static_params.r_s.shape == (1024,)
    assert rollout_path(fleet) == "pmsm_fused"
    jfleet = JR.randomize_env(J.PMSM, JKEY, {"r_s": JR.Uniform(15e-3, 21e-3)}, batch_size=1024, defaults=defaults,
                              saturated=True, motor_variant=J.MotorVariant.BRUSA)
    np.testing.assert_array_equal(fleet.env_properties.static_params.r_s.numpy(),
                                  np.asarray(jfleet.env_properties.static_params.r_s))


def test_resample_env_properties():
    env = PR.randomize_env(P.Pendulum, KEY, {"l": PR.Uniform(0.5, 2.0)}, batch_size=B, **F64)
    jenv = JR.randomize_env(J.Pendulum, JKEY, {"l": JR.Uniform(0.5, 2.0)}, batch_size=B)
    spec = {"l": PR.Uniform(0.5, 2.0)}
    props1 = PR.resample_env_properties(env, R.PRNGKey(1, "cpu"), spec)
    props2 = PR.resample_env_properties(env, R.PRNGKey(2, "cpu"), spec)
    want = JR.resample_env_properties(jenv, jax.random.PRNGKey(1), {"l": JR.Uniform(0.5, 2.0)})
    np.testing.assert_array_equal(props1.static_params.l.numpy(), np.asarray(want.static_params.l))
    assert props1.static_params.l.shape == (B,) and props1.static_params.l.dtype == torch.float64
    assert not torch.equal(props1.static_params.l, props2.static_params.l)
    assert props1.static_params.g == 9.81
    assert env.env_properties.static_params.l is not props1.static_params.l
    # the batched calls read env.env_properties at each call
    _, state = env.vmap_reset()
    action = torch.full((B, 1), 0.5, dtype=torch.float64)
    env.env_properties = props1
    _, s1 = env.vmap_step(state, action)
    env.env_properties = props2
    _, s2 = env.vmap_step(state, action)
    assert not torch.equal(s1.physical_state.omega, s2.physical_state.omega)
    _, js = jenv.vmap_reset()
    _, js1 = jax.vmap(jenv.step, in_axes=(0, 0, jenv.in_axes_env_properties))(js, jnp.full((B, 1), 0.5), want)
    np.testing.assert_allclose(s1.physical_state.omega.numpy(), np.asarray(js1.physical_state.omega), rtol=1e-12,
                               atol=1e-12)
    plain = P.Pendulum(batch_size=B, **F64)
    with pytest.raises(ValueError, match="per-batch"):
        PR.resample_env_properties(plain, KEY, spec)
    with pytest.raises(ValueError, match="no field"):
        PR.resample_env_properties(env, KEY, {"nope": (0.0, 1.0)})


def test_randomize_pmsm_drive_fleet():
    """Per-batch stator resistance through randomize_env with the motor
    preset's defaults.  Unlike the JAX package's drive kernel, which needs
    ``batch % 1024 == 0``, the port's takes any batch size: a fleet of 32
    stays in kernel scope."""
    defaults = dict(P.MotorVariant.DEFAULT.get_params().static_params.__dict__)
    env = PR.randomize_env(P.PMSM, KEY, {"r_s": PR.Uniform(15e-3, 20e-3)}, batch_size=32, defaults=defaults,
                           saturated=False, **F64)
    r_s = env.env_properties.static_params.r_s.numpy()
    assert r_s.shape == (32,) and (r_s >= 15e-3).all() and (r_s <= 20e-3).all() and len(np.unique(r_s)) > 1
    _, st = env.vmap_reset(R.split(R.PRNGKey(1, "cpu"), 32))
    obs, _ = env.vmap_step(st, torch.full((32, 2), 0.1, dtype=torch.float64))
    assert bool(torch.isfinite(obs[:, :4]).all())
    assert rollout_path(env) == "pmsm_fused"
    props2 = PR.resample_env_properties(env, R.PRNGKey(2, "cpu"), {"r_s": PR.Uniform(15e-3, 20e-3)})
    assert props2.static_params.r_s.shape == (32,)
    assert not np.array_equal(props2.static_params.r_s.numpy(), r_s)


def test_a_jax_normal_fleet_carries_across_with_its_properties():
    """A fleet whose draws differ in their last bits (``Normal``) is carried
    across as numpy: ``properties_from_numpy`` takes the (B,) leaves, and
    the port's own draw stays within the normals' tolerance of it."""
    from exciting_environments_torch.utils.convert import properties_from_numpy

    jenv = JR.randomize_env(J.Pendulum, JKEY, {"l": JR.Normal(1.0, 0.2, clip=(0.5, 1.5))}, batch_size=B)
    env = PR.randomize_env(P.Pendulum, KEY, {"l": PR.Normal(1.0, 0.2, clip=(0.5, 1.5))}, batch_size=B, **F64)
    jp = jenv.env_properties
    norms = lambda group: {f: (getattr(group, f).min, getattr(group, f).max) for f in group.__dataclass_fields__}
    props = properties_from_numpy(env, {k: np.asarray(v) for k, v in jp.static_params.__dict__.items()},
                                  norms(jp.physical_normalizations), norms(jp.action_normalizations))
    assert props.static_params.l.shape == (B,) and props.static_params.g == 9.81
    np.testing.assert_array_equal(props.static_params.l.numpy(), np.asarray(jp.static_params.l))
    np.testing.assert_allclose(env.env_properties.static_params.l.numpy(), np.asarray(jp.static_params.l), rtol=0,
                               atol=NORMAL_ATOL[torch.float64])
