"""The port's ``MujucoWrapper`` (``wrappers/mujoco.py``, host ``cpu``
backend) against the JAX package's ``cpu`` backend, in float64: the seven
cases of ``tests/test_mujoco_wrapper.py`` on its pendulum model (an XML
string, nothing downloaded).

Both backends step ``mujoco.mj_step`` on the host in float64, so from one
state ``qpos``/``qvel``/``time`` equal JAX's exactly step after step.  The
random reset draws the same uniforms (bit for bit); the denormalization
``(u + 1) / 2 * span + min`` is one multiply-add that XLA's CPU contracts
into a fused one, so a coordinate drawn or rebuilt from normalized values
may sit one ulp of its span from JAX's (``ULP_OF_SPAN``: the hinge's span is
3, its speed's 20); the stepping case therefore starts both from the JAX
reset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from exciting_environments_torch.utils import MinMaxNormalization
from exciting_environments_torch.wrappers.mujoco import MJX_AVAILABLE, MjCpuData, MujucoWrapper, dict_to_pytree_dataclass
from exciting_environments_tpu.utils import MinMaxNormalization as JMinMaxNormalization
from exciting_environments_tpu.wrappers import mujoco as jmujoco

F64 = dict(device="cpu", dtype=torch.float64)
ULP_OF_SPAN = {"qpos": 3.0 * 2.0**-52, "qvel": 20.0 * 2.0**-52}

# hinge pendulum with limited joint + limited motor: all normalizations derivable
PENDULUM_XML = """
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


@pytest.fixture(scope="module")
def model():
    return mujoco.MjModel.from_xml_string(PENDULUM_XML)


def _wrapper(model, W, to_dc, MM, **kw):
    qvel_dc, _ = to_dc("qvel", {"hinge_angular_velocity": MM(min=-10.0, max=10.0)})
    base = W.__new__(W)
    phys = base.generate_physical_normalization_dataclasses.__get__(base)(model)
    return W(model, physical_normalizations=W.PhysicalNormalizations(qpos=phys.qpos, qvel=qvel_dc), batch_size=4,
             **kw)


@pytest.fixture(scope="module")
def wrapper(model):
    return _wrapper(model, MujucoWrapper, dict_to_pytree_dataclass, MinMaxNormalization, **F64)


@pytest.fixture(scope="module")
def jwrapper(model):
    return _wrapper(model, jmujoco.MujucoWrapper, jmujoco.dict_to_pytree_dataclass, JMinMaxNormalization,
                    backend="cpu")


def _keys(seed):
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    return k, torch.as_tensor(np.asarray(k).astype(np.int64))


def test_normalization_synthesis(model):
    base = MujucoWrapper.__new__(MujucoWrapper)
    phys = base.generate_physical_normalization_dataclasses.__get__(base)(model)
    assert phys.qpos.hinge_angle.min == -1.5 and phys.qpos.hinge_angle.max == 1.5
    assert np.isnan(phys.qvel.hinge_angular_velocity.min)
    act = base.generate_action_normalization_dataclasses.__get__(base)(model)
    assert act.torque.min == -2 and act.torque.max == 2
    assert base.qpos_is_angle == [1]


def test_nan_gate_and_backends(model):
    """Missing qvel normalizations -> ValueError; ``backend="mjx"`` -> an
    ImportError naming mujoco-mjx (the port has no MJX); an unknown backend
    -> ValueError; no device without CUDA -> RuntimeError."""
    assert MJX_AVAILABLE is False
    with pytest.raises(ValueError, match="physical_normalizations"):
        MujucoWrapper(model, batch_size=2, **F64)
    with pytest.raises(ImportError, match="mujoco-mjx"):
        MujucoWrapper(model, batch_size=2, backend="mjx", **F64)
    with pytest.raises(ValueError, match="backend"):
        MujucoWrapper(model, batch_size=2, backend="gpu", **F64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _wrapper(model, MujucoWrapper, dict_to_pytree_dataclass, MinMaxNormalization)


def test_reset_and_step_match_jax(wrapper, jwrapper):
    """The default reset and ten steps equal the JAX ``cpu`` backend's
    exactly; a keyed reset within one ulp."""
    obs, state = wrapper.vmap_reset()
    jobs, jstate = jwrapper.vmap_reset()
    assert obs.shape == (4, wrapper.qpos_dim + wrapper.qvel_dim) and isinstance(state, MjCpuData)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    jk, pk = _keys(5)
    _, state = wrapper.vmap_reset(pk)
    _, jstate = jwrapper.vmap_reset(jk)
    np.testing.assert_allclose(state.qpos.numpy(), np.asarray(jstate.qpos), rtol=0, atol=ULP_OF_SPAN["qpos"])
    state = MjCpuData(*(torch.as_tensor(np.asarray(getattr(jstate, f))) for f in ("qpos", "qvel", "act", "time")))
    for t in range(10):
        a = 0.7 * np.cos(t + np.arange(4))[:, None]
        obs, state = wrapper.vmap_step(state, torch.as_tensor(a))
        jobs, jstate = jwrapper.vmap_step(jstate, jnp.asarray(a))
        for f in ("qpos", "qvel", "act", "time"):
            np.testing.assert_array_equal(getattr(state, f).numpy(), np.asarray(getattr(jstate, f)), err_msg=f)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-15, atol=1e-15)
    assert bool(torch.isfinite(obs).all())


def test_dynamics_respond_to_torque(wrapper):
    _, state = wrapper.vmap_reset()
    for _ in range(5):
        obs_pos, state = wrapper.vmap_step(state, torch.ones(4, 1, dtype=torch.float64))
    _, state2 = wrapper.vmap_reset()
    for _ in range(5):
        obs_neg, state2 = wrapper.vmap_step(state2, -torch.ones(4, 1, dtype=torch.float64))
    assert not torch.allclose(obs_pos, obs_neg)


def test_cpu_step_is_pure(wrapper):
    """The shared scratch MjData does not leak solver warm-start state across
    samples and calls: the same (state, action) maps to the same output
    whatever was stepped before."""
    _, state = wrapper.vmap_reset(_keys(5)[1])
    act = 0.7 * torch.ones(4, 1, dtype=torch.float64)
    first = wrapper.vmap_step(state, act)
    _, other = wrapper.vmap_reset(_keys(9)[1])
    for _ in range(10):
        _, other = wrapper.vmap_step(other, -torch.ones(4, 1, dtype=torch.float64))
    second = wrapper.vmap_step(state, act)
    assert torch.equal(first[0], second[0])
    for f in ("qpos", "qvel", "act", "time"):
        assert torch.equal(getattr(first[1], f), getattr(second[1], f))


def test_single_step_matches_vmap_entry(wrapper):
    _, state = wrapper.vmap_reset(_keys(2)[1])
    single = MjCpuData(*(getattr(state, f)[0] for f in ("qpos", "qvel", "act", "time")))
    obs_single, _ = wrapper.step(single, 0.3 * torch.ones(1, dtype=torch.float64), wrapper.env_properties)
    obs_batch, _ = wrapper.vmap_step(state, 0.3 * torch.ones(4, 1, dtype=torch.float64))
    assert torch.equal(obs_single, obs_batch[0])


def test_generate_state_from_observation_roundtrip(wrapper, jwrapper):
    """obs -> state -> obs, and the rebuilt state equals JAX's from the same
    observations."""
    obs, _ = wrapper.vmap_reset(_keys(0)[1])
    state = wrapper.vmap_generate_state_from_observation(obs)
    obs_rt = wrapper.generate_observation(state, wrapper.env_properties)
    np.testing.assert_allclose(obs_rt.numpy(), obs.numpy(), rtol=1e-12, atol=1e-12)
    jstate = jwrapper.vmap_generate_state_from_observation(jnp.asarray(obs.numpy()))
    for f in ("qpos", "qvel"):  # the same multiply-add
        np.testing.assert_allclose(getattr(state, f).numpy(), np.asarray(getattr(jstate, f)), rtol=0,
                                   atol=ULP_OF_SPAN[f])
