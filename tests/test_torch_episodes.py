"""The port's episode helpers (``utils/episodes.py``) against the JAX
package's, from the same keys, on CPU tensors in float64.

Keys compare bit for bit; floats within 1e-12 (rtol and atol).  The
Pendulum's keyed reset draws the JAX package's bits, so
``reset_with_references`` agrees from the key alone.  The PMSM's keyed
reset draws its current disc with other bits (``init_state``), so its
cases carry the JAX package's state across (``state_from_numpy`` with its
keys and references) and hold ``step_with_flags`` from there; its own
reset is held to the same keys, angle, speed and the reference's band.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.utils import episodes as jep
from exciting_environments_torch.utils import episodes as pep
from exciting_environments_torch.utils.convert import state_from_numpy

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-12, atol=1e-12)
PMSM_FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, torch.as_tensor(np.asarray(k).astype(np.int64))


def _close(t, j):
    np.testing.assert_allclose(torch.as_tensor(t).double().numpy(), np.asarray(j, dtype=np.float64), **TOL)


def _pendulums(batch=16, **kw):
    return (J.Pendulum(batch_size=batch, tau=2e-2, control_state=["theta"], **kw),
            P.Pendulum(batch_size=batch, tau=2e-2, control_state=["theta"], **kw, **F64))


@pytest.mark.parametrize("seed", [0, 7])
def test_reset_with_references_matches_jax(seed):
    je, pe = _pendulums()
    jk, pk = _key(seed)
    obs_j, js = jep.reset_with_references(je, jk)
    obs_p, ps = pep.reset_with_references(pe, pk)
    np.testing.assert_array_equal(ps.PRNGKey.numpy(), np.asarray(js.PRNGKey).astype(np.int64))
    for name in ("theta", "omega"):
        _close(getattr(ps.physical_state, name), getattr(js.physical_state, name))
    _close(ps.reference.theta, js.reference.theta)
    _close(obs_p, obs_j)
    assert bool(torch.isfinite(obs_p).all())


def test_draw_references_without_control_state_keeps_the_state():
    pe = P.Pendulum(batch_size=4, **F64)
    _, ps = pe.vmap_reset()
    assert pep.draw_references(pe, ps, _key(0)[1]) is ps


@pytest.mark.parametrize("max_episode_steps", [None, 3])
def test_step_with_flags_matches_jax(max_episode_steps):
    je, pe = _pendulums()
    jk, pk = _key(3)
    _, js = jep.reset_with_references(je, jk)
    _, ps = pep.reset_with_references(pe, pk)
    rng = np.random.default_rng(1)
    elapsed_j, elapsed_p = jnp.zeros(16, jnp.int32), torch.zeros(16, dtype=torch.int32)
    for _ in range(4):
        a = rng.uniform(-1.0, 1.0, (16, 1))
        out_j = jep.step_with_flags(je, js, jnp.asarray(a), elapsed_j, max_episode_steps)
        out_p = pep.step_with_flags(pe, ps, torch.as_tensor(a), elapsed_p, max_episode_steps)
        obs_j, js, rew_j, term_j, trunc_j, elapsed_j = out_j
        obs_p, ps, rew_p, term_p, trunc_p, elapsed_p = out_p
        _close(obs_p, obs_j)
        _close(rew_p, rew_j)
        assert rew_p.shape == (16,) and term_p.shape == (16,) and trunc_p.shape == (16,)
        np.testing.assert_array_equal(term_p.numpy(), np.asarray(term_j))
        np.testing.assert_array_equal(trunc_p.numpy(), np.asarray(trunc_j))
        np.testing.assert_array_equal(elapsed_p.numpy(), np.asarray(elapsed_j))
    assert pep.step_with_flags(pe, ps, torch.zeros(16, 1, dtype=torch.float64))[5] is None
    if max_episode_steps is not None:
        assert bool(trunc_p.all())


def _pmsm_pair(batch=32, seed=0):
    kw = dict(batch_size=batch, saturated=True, control_state=["i_d", "i_q"])
    je = J.PMSM(motor_variant=J.MotorVariant.BRUSA, **kw)
    pe = P.PMSM(motor_variant=P.MotorVariant.BRUSA, **kw, **F64)
    jk, pk = _key(seed)
    return je, pe, jk, pk


def test_pmsm_reset_with_references_keys_and_band():
    je, pe, jk, pk = _pmsm_pair()
    _, js = jep.reset_with_references(je, jk)
    obs_p, ps = pep.reset_with_references(pe, pk)
    np.testing.assert_array_equal(ps.PRNGKey.numpy(), np.asarray(js.PRNGKey).astype(np.int64))
    for name in ("epsilon", "omega_el"):
        _close(getattr(ps.physical_state, name), getattr(js.physical_state, name))
    pn = pe.env_properties.physical_normalizations
    for name in ("i_d", "i_q"):
        ref = getattr(ps.reference, name)
        band = getattr(pn, name)
        assert bool(((ref >= band.min) & (ref <= band.max)).all())
    assert obs_p.shape == (32, 10) and bool(torch.isfinite(obs_p).all())


def test_pmsm_step_with_flags_matches_jax_from_its_state():
    je, pe, jk, _ = _pmsm_pair()
    _, js = jep.reset_with_references(je, jk)
    arrays = {n: np.asarray(getattr(js.physical_state, n)) for n in PMSM_FIELDS}
    refs = {n: np.asarray(getattr(js.reference, n)) for n in ("i_d", "i_q")}
    full = {n: np.full(32, np.nan) for n in PMSM_FIELDS if n not in refs}
    ps = state_from_numpy(pe, arrays, reference={**full, **refs}, keys=np.asarray(js.PRNGKey))
    rng = np.random.default_rng(2)
    elapsed_j, elapsed_p = jnp.zeros(32, jnp.int32), torch.zeros(32, dtype=torch.int32)
    for _ in range(3):
        a = rng.uniform(-1.0, 1.0, (32, 2))
        obs_j, js, rew_j, term_j, trunc_j, elapsed_j = jep.step_with_flags(je, js, jnp.asarray(a), elapsed_j, 8)
        obs_p, ps, rew_p, term_p, trunc_p, elapsed_p = pep.step_with_flags(pe, ps, torch.as_tensor(a), elapsed_p, 8)
        _close(obs_p, obs_j)
        _close(rew_p, rew_j)
        np.testing.assert_array_equal(term_p.numpy(), np.asarray(term_j))
        np.testing.assert_array_equal(trunc_p.numpy(), np.asarray(trunc_j))


def test_tree_where_selects_per_instance():
    pe = P.Pendulum(batch_size=4, control_state=["theta"], **F64)
    _, a = pep.reset_with_references(pe, _key(0)[1])
    _, b = pep.reset_with_references(pe, _key(1)[1])
    mask = torch.tensor([True, False, True, False])
    c = pep.tree_where(mask, a, b)
    for name in ("theta", "omega"):
        want = torch.where(mask, getattr(a.physical_state, name), getattr(b.physical_state, name))
        assert torch.equal(getattr(c.physical_state, name), want)
    assert torch.equal(c.PRNGKey, torch.where(mask[:, None], a.PRNGKey, b.PRNGKey))
    assert torch.equal(c.reference.theta, torch.where(mask, a.reference.theta, b.reference.theta))
