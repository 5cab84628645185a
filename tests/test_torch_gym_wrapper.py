"""The port's ``GymWrapper`` (``wrappers/gym.py``) against the JAX package's,
on CPU tensors in float64: the eight cases of ``tests/test_gym_wrapper.py``,
and a run through several reference renewals from the same keys.

Hold steps, keys and flags equal the JAX wrapper's exactly (the keys of
``ops/random.py`` are threefry bit for bit).  The references are the
environment's ``init_state`` draws, whose uniforms are bit for bit too; its
denormalization ``(u + 1) / 2 * span + min`` is one multiply-add that XLA's
CPU contracts into a fused one and PyTorch rounds twice, so a reference may
sit one ulp of the span's scale from JAX's (held at 4.5e-16, one ulp at pi).  Observations and rewards
within 1e-12 for the same reason.  The
PMSM's keyed reset draws its current disc with other bits, so the registry
sweep compares its default (key-less) reset and step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_torch as P
import exciting_environments_tpu as J
from exciting_environments_torch.core import structures

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-12, atol=1e-12)


def _key(k):
    return torch.as_tensor(np.asarray(k).astype(np.int64))


def _close(t, j):
    np.testing.assert_allclose(torch.as_tensor(t).double().numpy(), np.asarray(j, dtype=np.float64), **TOL)


@pytest.mark.parametrize("env_id", list(P.EnvironmentRegistry), ids=lambda e: e.name)
def test_step_returns_correct_outputs(env_id):
    """A wrapper step agrees with the raw ``vmap_step`` observation and with
    the JAX wrapper's step, in shape and value."""
    env = env_id.make(batch_size=4, **F64)
    gym_env = P.GymWrapper(env=env)
    action = torch.ones(env.batch_size, env.action_dim, dtype=torch.float64)
    _, state = env.vmap_reset()
    new_obs, _ = env.vmap_step(state, action)
    gym_env.reset()
    new_obs_gym, reward, terminated, truncated = gym_env.step(action)
    assert torch.equal(new_obs, new_obs_gym)
    assert reward.shape == (4, 1) and terminated.shape == (4, 1)

    jg = J.GymWrapper(env=J.EnvironmentRegistry[env_id.name].make(batch_size=4))
    jg.reset()
    jout = jg.step(jnp.ones((4, env.action_dim)))
    for name, p, j in zip(("obs", "reward", "terminated", "truncated"), (new_obs_gym, reward, terminated, truncated),
                          jout):
        assert tuple(p.shape) == tuple(j.shape), name
        if p.dtype == torch.bool:
            np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=name)
        else:
            _close(p, j)


@pytest.mark.parametrize("env_id", list(P.EnvironmentRegistry), ids=lambda e: e.name)
def test_gym_wrapper_ref_generation(env_id):
    env = env_id.make(batch_size=4, **F64)
    gym_env = P.GymWrapper(env=env)
    rng = torch.stack([R_key(i) for i in range(4)])
    gym_env.reset(rng_env=rng, rng_ref=rng)
    assert gym_env.ref_gen
    assert gym_env.reference_hold_steps.shape == (gym_env.env.batch_size, 1)


def R_key(seed):
    return _key(jax.random.PRNGKey(seed))


def test_from_env_factory():
    gym_env = P.GymWrapper.from_env(P.EnvironmentRegistry.PENDULUM, batch_size=3, **F64)
    assert gym_env.env.batch_size == 3


def test_reference_tracking_matches_jax_through_renewals():
    """With a control state and reference generation on, 12 steps with hold
    steps in [2, 5) renew every instance's reference several times: hold
    counters, references and flags equal the JAX wrapper's, observations
    and rewards within 1e-12."""
    B = 4
    params = {"hold_steps_min": 2, "hold_steps_max": 5}
    jg = J.GymWrapper(env=J.Pendulum(batch_size=B), control_state=["theta"], ref_params=params)
    pg = P.GymWrapper(env=P.Pendulum(batch_size=B, **F64), control_state=["theta"], ref_params=params)
    rk = jax.vmap(jax.random.PRNGKey)(jnp.arange(B))
    jo, _ = jg.reset(rng_env=rk, rng_ref=jax.random.PRNGKey(7))
    po, _ = pg.reset(rng_env=_key(rk), rng_ref=R_key(7))
    assert po.shape == (B, 3)  # theta, omega, theta_ref
    _close(po, jo)
    np.testing.assert_array_equal(pg.reference_hold_steps.numpy(), np.asarray(jg.reference_hold_steps))
    renewals = 0
    for t in range(12):
        a = 0.3 * np.sin(t + np.arange(B))[:, None]
        jout, pout = jg.step(jnp.asarray(a)), pg.step(torch.as_tensor(a))
        renewals += int((pg.reference_hold_steps == pg.ref_params["hold_steps_max"] - 2).sum())
        np.testing.assert_array_equal(pg.reference_hold_steps.numpy(), np.asarray(jg.reference_hold_steps))
        _close(pout[0], jout[0])
        _close(pout[1], jout[1])
        np.testing.assert_array_equal(pout[2].numpy(), np.asarray(jout[2]))
        np.testing.assert_array_equal(pout[3].numpy(), np.asarray(jout[3]))
        jstate = jax.tree_util.tree_unflatten(jg.state_tree_struct, jg.state)
        pstate = structures.unflatten(pg.state_tree_struct, pg.state)
        np.testing.assert_allclose(pstate.reference.theta.numpy(), np.asarray(jstate.reference.theta), rtol=0,
                                   atol=4.5e-16)
        np.testing.assert_array_equal(pstate.PRNGKey.numpy(), np.asarray(jstate.PRNGKey).astype(np.int64))
    assert bool(torch.isfinite(pout[1]).all()) and pout[1].shape == (B, 1)
    assert renewals > 0


def test_custom_ref_params():
    """User-provided ref_params are honored."""
    gym_env = P.GymWrapper(env=P.Pendulum(batch_size=4, **F64), control_state=["theta"],
                           ref_params={"hold_steps_min": 2, "hold_steps_max": 5})
    assert gym_env.ref_params == {"hold_steps_min": 2, "hold_steps_max": 5}
    gym_env.reset(rng_ref=R_key(3))
    assert bool((gym_env.reference_hold_steps >= 2).all()) and bool((gym_env.reference_hold_steps < 5).all())


def test_ref_generation_enabled_after_first_step():
    """Turning reference generation on after a step without it takes effect
    at once: the flag is read on every call (JAX's jit cache case)."""
    gym_env = P.GymWrapper(env=P.Pendulum(batch_size=4, **F64), control_state=["theta"])
    gym_env.reset()
    gym_env.step(torch.zeros(4, 1, dtype=torch.float64))
    gym_env.reset(rng_ref=R_key(1))
    hold0 = gym_env.reference_hold_steps.clone()
    gym_env.step(torch.zeros(4, 1, dtype=torch.float64))
    assert bool((gym_env.reference_hold_steps == hold0 - 1).all())


def test_reset_with_initial_state():
    """Resetting to a caller-provided flattened state restores it exactly."""
    gym_env = P.GymWrapper(env=P.EnvironmentRegistry.MASS_SPRING_DAMPER.make(batch_size=3, **F64))
    for _ in range(5):
        gym_env.step(0.7 * torch.ones(3, 1, dtype=torch.float64))
    saved = [leaf.clone() if isinstance(leaf, torch.Tensor) else leaf for leaf in gym_env.state]
    gym_env.step(0.7 * torch.ones(3, 1, dtype=torch.float64))
    gym_env.reset(initial_state=saved)
    for a, b in zip(gym_env.state, saved):
        if isinstance(a, torch.Tensor):
            assert torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0))
        else:
            assert a == b


def test_custom_reward_function():
    """User-supplied reward/terminated/truncated functions replace the env's
    (called on the whole batch)."""
    def my_reward(state, action, env_properties):
        return torch.full((action.shape[0], 1), 42.0)

    gym_env = P.GymWrapper(env=P.Pendulum(batch_size=2, **F64), generate_reward=my_reward)
    gym_env.reset()
    _, reward, _, _ = gym_env.step(torch.zeros(2, 1, dtype=torch.float64))
    assert bool((reward == 42.0).all())
    with pytest.raises(NotImplementedError):
        gym_env.render()
