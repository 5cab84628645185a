"""Checkpoint/resume of the port's states (``utils/checkpoint.py``): the JAX
package's ``tests/test_checkpoint.py`` on CPU tensors (its two orbax tests
become the port's refusal of ``use_orbax=True``), and states saved by
either package loading in the other (the JAX side with
``use_orbax=False``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.utils import checkpoint as jck
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import checkpoint
from exciting_environments_torch.utils.checkpoint import ORBAX_AVAILABLE, load_state, save_state

F64 = dict(device="cpu", dtype=torch.float64)
PMSM_FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")


def test_state_roundtrip_and_resume(tmp_path):
    env = P.Pendulum(batch_size=8, **F64)
    _, state = env.vmap_reset()
    for _ in range(5):
        _, state = env.vmap_step(state, 0.4 * torch.ones((8, 1), dtype=torch.float64))
    path = save_state(state, str(tmp_path / "state.npz"))
    restored = load_state(env.vmap_init_state(), path)
    assert torch.equal(restored.physical_state.theta, state.physical_state.theta)
    obs_a, _ = env.vmap_step(state, 0.1 * torch.ones((8, 1), dtype=torch.float64))
    obs_b, _ = env.vmap_step(restored, 0.1 * torch.ones((8, 1), dtype=torch.float64))
    assert torch.equal(obs_a, obs_b)


def test_structure_mismatch_rejected(tmp_path):
    env = P.Pendulum(batch_size=8, **F64)
    other = P.MassSpringDamper(batch_size=8, **F64)
    _, state = env.vmap_reset()
    path = save_state(state, str(tmp_path / "state.npz"))
    with pytest.raises(ValueError, match="path mismatch|leaves"):
        load_state(other.vmap_init_state(), path)


def test_trajectory_checkpoint(tmp_path):
    env = P.FluidTank(batch_size=4, **F64)
    _, s0 = env.vmap_reset()
    acts = 0.5 * torch.ones((4, 10, 1), dtype=torch.float64)
    _, states, _ = env.vmap_sim_ahead(s0, acts, env.tau, env.tau)
    path = save_state(states, str(tmp_path / "traj.npz"))
    restored = load_state(states, path)
    assert torch.equal(restored.physical_state.height, states.physical_state.height)


def test_load_state_rejects_shape_mismatch(tmp_path):
    tree = {"a": torch.ones((8, 2), dtype=torch.float64), "b": torch.zeros(3, dtype=torch.float64)}
    path = save_state(tree, str(tmp_path / "ck.npz"))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_state({"a": torch.ones((16, 2), dtype=torch.float64), "b": torch.zeros(3, dtype=torch.float64)}, path)
    with pytest.raises(ValueError, match="dtype mismatch"):
        load_state({"a": torch.ones((8, 2), dtype=torch.float32), "b": torch.zeros(3, dtype=torch.float64)}, path)


def test_orbax_is_refused(tmp_path):
    """The JAX package's two orbax tests: the port has no orbax backend, and
    says so on save and on load."""
    assert ORBAX_AVAILABLE is False
    env = P.Pendulum(batch_size=4, **F64)
    _, state = env.vmap_reset()
    with pytest.raises(ValueError, match="orbax"):
        save_state(state, str(tmp_path / "ckpt"), use_orbax=True)
    path = save_state(state, str(tmp_path / "ckpt"))
    assert path.endswith(".npz")
    with pytest.raises(ValueError, match="orbax"):
        load_state(env.vmap_init_state(), str(tmp_path / "ckpt"), use_orbax=True)


def test_keys_and_device_of_the_template(tmp_path):
    """Keys survive as int64 words; the loaded leaves take the template's
    dtype and device, and a fresh state's Python-scalar leaf loads as a
    batch-shaped tensor."""
    env = P.Pendulum(batch_size=3, process_noise={"omega": 0.1}, **F64)
    _, state = env.vmap_reset(prng.split(prng.PRNGKey(4, "cpu"), 3))
    assert state.additions.active_solver_state is False
    path = save_state(state, str(tmp_path / "s"))
    restored = load_state(env.vmap_init_state(prng.split(prng.PRNGKey(5, "cpu"), 3)), path)
    assert restored.PRNGKey.dtype == torch.int64 and torch.equal(restored.PRNGKey, state.PRNGKey)
    assert torch.equal(restored.additions.active_solver_state, torch.zeros(3, dtype=torch.bool))
    a = 0.2 * torch.ones((3, 1), dtype=torch.float64)
    assert torch.equal(env.vmap_step(state, a)[0], env.vmap_step(restored, a)[0])


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def _pendulum_pair():
    je = J.Pendulum(batch_size=4, control_state=["theta"], process_noise={"omega": 0.1})
    pe = P.Pendulum(batch_size=4, control_state=["theta"], process_noise={"omega": 0.1}, **F64)
    _, js = je.vmap_reset(jax.random.split(jax.random.PRNGKey(3), 4))
    for _ in range(3):
        _, js = je.vmap_step(js, 0.3 * jnp.ones((4, 1)))
    return je, pe, js


def _pmsm_pair():
    je = J.PMSM(batch_size=4, control_state=["i_d", "i_q"])
    pe = P.PMSM(batch_size=4, control_state=["i_d", "i_q"], **F64)
    _, js = je.vmap_reset(jax.random.split(jax.random.PRNGKey(6), 4))
    for _ in range(3):
        _, js = je.vmap_step(js, 0.2 * jnp.ones((4, 2)))
    return je, pe, js


def _assert_same(port_state, jax_state):
    port = checkpoint.leaves_with_path(port_state)
    ref = jax.tree_util.tree_leaves_with_path(jax_state)
    assert [p for p, _ in port] == [jax.tree_util.keystr(k) for k, _ in ref]
    for (_, a), (_, b) in zip(port, ref):
        b = np.asarray(b)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.astype(b.dtype) if b.dtype == np.uint32 else a, b)


@pytest.mark.parametrize("pair", [_pendulum_pair, _pmsm_pair], ids=["pendulum", "pmsm"])
def test_a_jax_checkpoint_loads_in_the_port(tmp_path, pair):
    je, pe, js = pair()
    path = jck.save_state(js, str(tmp_path / "jax.npz"), use_orbax=False)
    like = pe.vmap_init_state(prng.split(prng.PRNGKey(0, "cpu"), 4))
    restored = load_state(like, path)
    _assert_same(restored, js)


@pytest.mark.parametrize("pair", [_pendulum_pair, _pmsm_pair], ids=["pendulum", "pmsm"])
def test_a_port_checkpoint_loads_in_jax(tmp_path, pair):
    je, pe, js = pair()
    # the JAX state carried into the port through a JAX checkpoint, stepped on
    # both sides, saved by the port and read back by the JAX package
    ps = load_state(pe.vmap_init_state(prng.split(prng.PRNGKey(0, "cpu"), 4)),
                    jck.save_state(js, str(tmp_path / "jax.npz"), use_orbax=False))
    a = np.full((4, pe.action_dim), -0.1)
    _, js = je.vmap_step(js, jnp.asarray(a))
    _, ps = pe.vmap_step(ps, torch.as_tensor(a))
    path = save_state(ps, str(tmp_path / "port"))
    restored = jck.load_state(je.vmap_init_state(jax.random.split(jax.random.PRNGKey(1), 4)), path, use_orbax=False)
    for (kp, r), (_, s) in zip(jax.tree_util.tree_leaves_with_path(restored), jax.tree_util.tree_leaves_with_path(js)):
        np.testing.assert_allclose(np.asarray(r, np.float64), np.asarray(s, np.float64), rtol=1e-12, atol=1e-12,
                                   err_msg=jax.tree_util.keystr(kp))
    # a fresh port state (Python-scalar active_solver_state) loads as well
    _, fresh = pe.vmap_reset(prng.split(prng.PRNGKey(2, "cpu"), 4))
    jck.load_state(je.vmap_init_state(jax.random.split(jax.random.PRNGKey(1), 4)),
                   save_state(fresh, str(tmp_path / "fresh")), use_orbax=False)
