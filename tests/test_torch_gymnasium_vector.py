"""The port's ``GymnasiumVectorEnv`` (``wrappers/gymnasium_vector.py``) and
its device step (``utils/episodes.py::_autoreset_step``) against the JAX
package's adapter, on CPU tensors in float64: the seven cases of
``tests/test_gymnasium_vector.py``.

From the same seeds, flags equal the JAX adapter's exactly through several
autoresets.  Both adapters return float32 numpy observations and rewards;
they agree within 1e-6 relative (the JAX test's own tolerance for these
outputs), and within 1e-5 under noise (normals agree to ``erfinv``'s last
bits, ROADMAP Accepted).
"""

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip("gymnasium")

import exciting_environments_torch as P
import exciting_environments_tpu as J
from exciting_environments_torch.ops import random as R
from exciting_environments_torch.utils import episodes
from exciting_environments_torch.wrappers.gymnasium_vector import GymnasiumVectorEnv
from exciting_environments_tpu.wrappers.gymnasium_vector import GymnasiumVectorEnv as JGymnasiumVectorEnv

F64 = dict(device="cpu", dtype=torch.float64)
B = 16


def _make(**kw):
    return GymnasiumVectorEnv(P.Pendulum(batch_size=B, control_state=["theta"], **F64), seed=3, **kw)


def test_is_gymnasium_vector_env_with_spaces():
    venv = _make()
    assert isinstance(venv, gymnasium.vector.VectorEnv)
    assert venv.num_envs == B
    assert venv.metadata["autoreset_mode"] == gymnasium.vector.AutoresetMode.NEXT_STEP
    assert venv.single_observation_space.shape == (3,)
    assert venv.single_action_space.shape == (1,)
    assert venv.observation_space.shape == (B, 3) and venv.action_space.shape == (B, 1)
    obs, info = venv.reset(seed=11)
    assert isinstance(obs, np.ndarray) and obs.dtype == np.float32
    assert obs.shape == (B, 3) and np.isfinite(obs).all() and info == {}
    obs, r, term, trunc, info = venv.step(venv.action_space.sample())
    for arr, dt in ((obs, np.float32), (r, np.float32), (term, bool), (trunc, bool)):
        assert isinstance(arr, np.ndarray) and arr.dtype == dt
    assert r.shape == (B,) and term.shape == (B,) and trunc.shape == (B,)
    with pytest.raises(RuntimeError, match="before reset"):
        _make().step(np.zeros((B, 1), np.float32))


def test_reset_is_seed_deterministic_and_reference_episodic():
    venv = _make()
    obs1, _ = venv.reset(seed=5)
    obs2, _ = venv.reset(seed=5)
    np.testing.assert_array_equal(obs1, obs2)
    obs3, _ = venv.reset(seed=6)
    assert not np.array_equal(obs1, obs3)
    venv.reset(seed=7)
    refs = []
    for _ in range(5):
        obs, r, term, trunc, _ = venv.step(np.zeros((B, 1), np.float32))
        if not (term.any() or trunc.any()):
            refs.append(obs[:, 2].copy())
    for other in refs[1:]:
        np.testing.assert_array_equal(refs[0], other)


def test_next_step_autoreset_protocol_matches_jax():
    """A sub-env that ended on step t returns its reset observation with
    reward 0 and cleared flags on step t+1; the time limit restarts.  Every
    step's flags equal the JAX adapter's, observations and rewards within
    1e-6 relative of its float32 outputs."""
    venv = _make(max_episode_steps=3)
    jvenv = JGymnasiumVectorEnv(J.Pendulum(batch_size=B, control_state=["theta"]), seed=3, max_episode_steps=3)
    steps = [np.zeros((B, 1), np.float32)] * 3 + [np.ones((B, 1), np.float32)] + [np.zeros((B, 1), np.float32)] * 3
    o, jo = venv.reset(seed=0)[0], jvenv.reset(seed=0)[0]
    np.testing.assert_allclose(o, jo, rtol=1e-6, atol=1e-7)
    out = []
    for a in steps:
        p, j = venv.step(a), jvenv.step(a)
        for x, y in zip(p[:2], j[:2]):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(p[2], j[2])
        np.testing.assert_array_equal(p[3], j[3])
        out.append(p)
    assert out[2][3].all()  # time limit hit everywhere
    obs4, r4, term4, trunc4, _ = out[3]
    assert (r4 == 0).all() and (~term4).all() and (~trunc4).all()
    assert not np.allclose(obs4, out[2][0])
    assert not out[4][3].any() and out[6][3].all()


def test_engine_truncation_reaches_the_api():
    """|obs| > 1 truncation (the engine's rule) surfaces as a (B,) bool."""
    with pytest.warns(UserWarning, match="control_state"):
        venv = GymnasiumVectorEnv(P.Pendulum(batch_size=B, tau=2e-2, **F64), seed=1)
    venv.reset(seed=1)
    saw = False
    for _ in range(300):
        _, _, term, trunc, _ = venv.step(np.full((B, 1), 1.0, np.float32))
        assert trunc.shape == (B,) and trunc.dtype == bool
        saw = saw or bool(trunc.any())
    assert saw


def test_matches_gym_wrapper_dynamics():
    """One adapter step equals GymWrapper's step on the same state and action."""
    from exciting_environments_torch.core import structures

    env = P.Pendulum(batch_size=B, control_state=["theta"], **F64)
    venv = GymnasiumVectorEnv(env, seed=2)
    venv.reset(seed=2)
    a = 0.3 * np.ones((B, 1), np.float32)
    gw = P.GymWrapper(env=env, control_state=["theta"])
    gw.state = structures.leaves(venv._state)
    obs_gw, r_gw, term_gw, trunc_gw = gw.step(torch.as_tensor(a, dtype=torch.float64))
    obs, r, term, trunc, _ = venv.step(a)
    np.testing.assert_array_equal(obs, obs_gw.numpy().astype(np.float32))
    np.testing.assert_array_equal(r, r_gw.numpy().reshape(B).astype(np.float32))
    np.testing.assert_array_equal(term, term_gw.numpy().reshape(B, -1).any(axis=1))
    np.testing.assert_array_equal(trunc, trunc_gw.numpy().reshape(B, -1).any(axis=1))


def test_from_registry_and_lazy_export():
    venv = P.GymnasiumVectorEnv.from_registry(P.EnvironmentRegistry.CART_POLE, num_envs=8, max_episode_steps=10,
                                              **F64)
    obs, _ = venv.reset(seed=0)
    assert obs.shape == (8, 4)
    obs, r, term, trunc, _ = venv.step(venv.action_space.sample())
    assert obs.shape == (8, 4) and np.isfinite(obs).all()


@pytest.mark.parametrize("noise_mode", ["exact", "fast"])
def test_vector_env_with_stochastic_env(noise_mode):
    """Stochastic envs in the adapter: two identically seeded adapters
    reproduce each other, the time limit fires (autoreset under noise), and
    the flags equal the JAX adapter's from the same seed."""
    kw = dict(batch_size=4, control_state=["theta"], process_noise={"omega": 0.3},
              observation_noise={"theta": 0.02}, noise_mode=noise_mode)
    a, b = (GymnasiumVectorEnv(P.Pendulum(**kw, **F64), max_episode_steps=8, seed=0) for _ in range(2))
    j = JGymnasiumVectorEnv(J.Pendulum(**kw), max_episode_steps=8, seed=0)
    obs_a, _ = a.reset(seed=3)
    np.testing.assert_array_equal(obs_a, b.reset(seed=3)[0])
    np.testing.assert_allclose(obs_a, j.reset(seed=3)[0], rtol=1e-6, atol=1e-6)
    act = np.zeros((4, 1), np.float32)
    saw_trunc = False
    for _ in range(20):
        oa, ra, ta, tra, _ = a.step(act)
        ob, rb, tb, trb, _ = b.step(act)
        oj, rj, tj, trj, _ = j.step(act)
        np.testing.assert_array_equal(oa, ob)
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(tra, trj)
        np.testing.assert_allclose(oa, oj, rtol=1e-5, atol=1e-6)
        saw_trunc = saw_trunc or bool(np.any(tra))
    assert saw_trunc


def test_autoreset_step_needs_no_gymnasium_and_skips_the_reset_draw():
    """The device step on its own: with no instance to reset it is exactly
    ``step_with_flags``; with some, only those take the fresh draw."""
    env = P.Pendulum(batch_size=B, control_state=["theta"], **F64)
    _, state = episodes.reset_with_references(env, R.PRNGKey(0, "cpu"))
    a = torch.full((B, 1), 0.2, dtype=torch.float64)
    el = torch.zeros(B, dtype=torch.int32)
    none = torch.zeros(B, dtype=torch.bool)
    k = R.PRNGKey(1, "cpu")
    out = episodes._autoreset_step(env, state, none, False, el, a, k, 5)
    ref = episodes.step_with_flags(env, state, a, el, 5)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[2]) and torch.equal(out[6], ref[5])
    some = torch.arange(B) % 3 == 0
    out = episodes._autoreset_step(env, state, some, True, el + 2, a, k, 5)
    obs_r, _ = episodes.reset_with_references(env, k)
    assert torch.equal(out[0][some], obs_r[some]) and torch.equal(out[0][~some], ref[0][~some])
    assert bool((out[1][some] == 0).all()) and bool((out[6][some] == 0).all()) and bool((out[6][~some] == 3).all())
