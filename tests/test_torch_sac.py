"""The port's SAC (``utils/sac.py``) against the JAX package's, on CPU
tensors in float64, and the counterparts of tests/test_sac.py's fast cases.

Tolerances: ``_sample_action`` (the squashed sample and its log-probability
with the softplus, at pre-squash values beyond 20 too) within 1e-12 (the
normal draws' ``erfinv`` and ``logaddexp``'s last bits); ``init_sac_agent``
within 1e-13; one update (``learning_starts`` 0, one iteration, one update)
within 1e-10 relative to each leaf's largest entry; ``train_sac`` over 3
iterations with ``learning_starts`` crossed inside the second (random
actions for its first three steps, the policy's after, updates from its
end), in both key-stream modes, within 1e-8 relative to each leaf's and
metric's largest entry; ``evaluate_sac`` within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.utils import sac as jsac
from exciting_environments_torch.utils import rl as prl
from exciting_environments_torch.utils import sac as psac
from exciting_environments_torch.utils.convert import agent_params_from_numpy

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-12, atol=1e-12)
#: 16 instances x 4 steps = 64 transitions per iteration: the gate at 100
#: falls inside the second iteration
CFG = dict(n_steps=4, updates_per_iteration=2, update_batch_size=64, buffer_capacity=4 * 16 * 8,
           learning_starts=100, max_episode_steps=6)


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, torch.as_tensor(np.asarray(k).astype(np.int64))


def _pair(batch=16):
    return (J.Pendulum(batch_size=batch, tau=2e-2, control_state=["theta"]),
            P.Pendulum(batch_size=batch, tau=2e-2, control_state=["theta"], **F64))


def _to_port(pe, tree):
    return agent_params_from_numpy(pe, jax.tree_util.tree_map(np.asarray, tree))


def _leaves_close(port_tree, jax_tree, rel):
    jl, pl = jax.tree_util.tree_leaves(jax_tree), prl.tree_leaves(port_tree)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        a = np.asarray(a, dtype=np.float64)
        assert float(np.abs(a - b.detach().numpy()).max()) <= rel * max(float(np.abs(a).max()), 1e-300)


def _metrics_close(port, ref, rel):
    for name, v in ref.items():
        v = np.asarray(v, dtype=np.float64)
        assert port[name].shape == v.shape, name
        assert float(np.abs(port[name].numpy() - v).max()) <= rel * max(float(np.abs(v).max()), 1e-300), name


def test_init_sac_agent_matches_jax():
    je, pe = _pair()
    jk, pk = _key(3)
    ref = jsac.init_sac_agent(je, jk)
    ours = psac.init_sac_agent(pe, pk)
    _leaves_close(ours, ref, 1e-13)
    assert set(ours) == {"actor", "q1", "q2", "q1_target", "q2_target", "log_alpha"}
    assert ours["log_alpha"].shape == () and ours["actor"][-1]["w"].shape == (128, 2)
    assert torch.equal(ours["q1"][0]["w"], ours["q1_target"][0]["w"])
    assert ours["q1"][0]["w"] is not ours["q1_target"][0]["w"]


@pytest.mark.parametrize("shift", [0.0, 30.0], ids=["near_zero", "beyond_softplus_threshold"])
def test_sample_action_matches_jax(shift):
    """The log-probability's ``softplus(-2 u)`` is ``logaddexp``: at |u| > 10
    ``torch.nn.functional.softplus``'s threshold would already differ."""
    je, pe = _pair()
    params = jsac.init_sac_agent(je, _key(0)[0])
    params["actor"][-1]["b"] = params["actor"][-1]["b"].at[0].set(shift)
    obs = np.random.default_rng(1).normal(size=(64, 3))
    jk, pk = _key(2)
    a_j, logp_j = jsac._sample_action(params, jnp.asarray(obs), jk)
    a_p, logp_p = psac._sample_action(_to_port(pe, params), torch.as_tensor(obs), pk)
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), **TOL)
    np.testing.assert_allclose(logp_p.numpy(), np.asarray(logp_j), **TOL)
    u = np.arctanh(np.clip(np.asarray(a_j), -1 + 1e-16, 1 - 1e-16))
    assert (np.abs(u) > 10).any() == (shift > 0)
    np.testing.assert_allclose(psac.sac_policy_mean(_to_port(pe, params), torch.as_tensor(obs)).numpy(),
                               np.asarray(jsac.sac_policy_mean(params, jnp.asarray(obs))), **TOL)


def test_one_update_matches_jax():
    je, pe = _pair()
    params = jsac.init_sac_agent(je, _key(4)[0])
    cfg = dict(CFG, updates_per_iteration=1, learning_starts=0)
    jk, pk = _key(5)
    res_j = jsac.train_sac(je, 1, key=jk, config=jsac.SACConfig(**cfg), params=params)
    res_p = psac.train_sac(pe, 1, key=pk, config=psac.SACConfig(**cfg), params=_to_port(pe, params))
    _metrics_close(res_p.metrics, res_j.metrics, 1e-10)
    _leaves_close(res_p.params, res_j.params, 1e-10)
    assert float(res_p.metrics["q_loss"][0]) != 0.0


@pytest.mark.parametrize("scan_iterations", [False, True], ids=["chained", "scan_iterations"])
def test_train_sac_matches_jax_across_learning_starts(scan_iterations):
    je, pe = _pair()
    params = jsac.init_sac_agent(je, _key(3)[0])
    jk, pk = _key(0)
    res_j = jsac.train_sac(je, 3, key=jk, config=jsac.SACConfig(**CFG), params=params,
                           scan_iterations=scan_iterations)
    res_p = psac.train_sac(pe, 3, key=pk, config=psac.SACConfig(**CFG), params=_to_port(pe, params),
                           scan_iterations=scan_iterations)
    _metrics_close(res_p.metrics, res_j.metrics, 1e-8)
    _leaves_close(res_p.params, res_j.params, 1e-8)
    q = res_p.metrics["q_loss"]
    assert float(q[0]) == 0.0 and float(q[1]) != 0.0 and float(q[2]) != 0.0


def test_evaluate_sac_matches_jax():
    je, pe = _pair()
    params = jsac.init_sac_agent(je, _key(3)[0])
    val = psac.evaluate_sac(pe, _to_port(pe, params), n_steps=8, max_episode_steps=32)
    np.testing.assert_allclose(val, jsac.evaluate_sac(je, params, n_steps=8, max_episode_steps=32), **TOL)


# ---------------------------------------------------------------------------
# the counterparts of tests/test_sac.py
# ---------------------------------------------------------------------------


def test_sac_mechanics():
    _, pe = _pair()
    cfg = psac.SACConfig(n_steps=4, updates_per_iteration=2, update_batch_size=64, buffer_capacity=4 * 16 * 8,
                         learning_starts=128, max_episode_steps=32)
    res = psac.train_sac(pe, iterations=5, key=_key(0)[1], config=cfg)
    assert set(res.metrics) == {"mean_reward", "q_loss", "actor_loss", "alpha", "entropy"}
    for name, v in res.metrics.items():
        assert v.shape == (5,) and bool(torch.isfinite(v).all()), name
    # 64 transitions after the first iteration < 128: no update; later ones update
    assert float(res.metrics["q_loss"][0]) == 0.0 and float(res.metrics["q_loss"][-1]) != 0.0
    assert bool((res.metrics["mean_reward"] <= 0).all())
    assert all(bool(torch.isfinite(x).all()) for x in prl.tree_leaves(res.params))


def test_sac_scan_iterations_mode():
    _, pe = _pair()
    cfg = psac.SACConfig(n_steps=4, updates_per_iteration=2, update_batch_size=64, buffer_capacity=4 * 16 * 8,
                         learning_starts=128, max_episode_steps=32)
    res = psac.train_sac(pe, iterations=4, key=_key(0)[1], config=cfg, scan_iterations=True)
    for name, v in res.metrics.items():
        assert v.shape == (4,) and bool(torch.isfinite(v).all()), name
    assert float(res.metrics["q_loss"][0]) == 0.0 and float(res.metrics["q_loss"][-1]) != 0.0


def test_sac_policy_and_eval():
    _, pe = _pair()
    params = psac.init_sac_agent(pe, _key(3)[1])
    act = psac.sac_policy_mean(params, torch.zeros((5, 3), dtype=torch.float64))
    assert act.shape == (5, 1) and bool((act.abs() <= 1.0).all())
    val = psac.evaluate_sac(pe, params, n_steps=8, max_episode_steps=32)
    assert isinstance(val, float) and np.isfinite(val)
    assert val == psac.evaluate_sac(pe, params, n_steps=8, max_episode_steps=32)


def test_sac_sample_action_is_squashed_and_consistent():
    """Sampled actions stay inside (-1, 1) and the log-probability matches
    the change of variables from the pre-squash Gaussian."""
    _, pe = _pair()
    params = psac.init_sac_agent(pe, _key(0)[1])
    obs = torch.as_tensor(np.random.default_rng(1).normal(size=(64, 3)))
    a, logp = psac._sample_action(params, obs, _key(2)[1])
    assert bool((a.abs() < 1.0).all()) and bool(torch.isfinite(logp).all())
    mean, log_std = psac._actor_dist(params, obs)
    u = torch.atanh(torch.clamp(a, -1 + 1e-9, 1 - 1e-9))
    g = torch.sum(-0.5 * ((u - mean) / torch.exp(log_std)) ** 2 - log_std - 0.5 * np.log(2 * np.pi), dim=-1)
    expected = g - torch.sum(torch.log(1.0 - torch.tanh(u) ** 2), dim=-1)
    torch.testing.assert_close(logp, expected, rtol=1e-6, atol=0)


def test_sac_buffer_capacity_validation():
    _, pe = _pair()
    with pytest.raises(ValueError, match="multiple"):
        psac.train_sac(pe, 1, key=_key(0)[1], config=psac.SACConfig(n_steps=3, buffer_capacity=100))


def test_agent_tree_keys_are_checked():
    _, pe = _pair()
    with pytest.raises(ValueError, match="keys"):
        agent_params_from_numpy(pe, {"actor": [], "critic": []})
    with pytest.raises(ValueError, match="layer"):
        agent_params_from_numpy(pe, {"actor": [{"w": np.zeros((3, 2)), "b": np.zeros(3)}], "log_std": np.zeros(1),
                                     "critic": []})
