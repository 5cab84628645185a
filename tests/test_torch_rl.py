"""The port's PPO (``utils/rl.py``) against the JAX package's, on CPU tensors
in float64, and the counterparts of tests/test_rl.py's fast cases.

Tolerances: GAE, the clipped-surrogate loss, its gradients and one step of
``ClippedAdam`` (optax's ``clip_by_global_norm`` then ``adam``) within
1e-12 (rtol and atol, gradients relative to each leaf's largest entry);
``init_agent`` within 1e-13 (the normal draws' ``erfinv``); ``train_ppo``
over 2 iterations on the tracking Pendulum at B = 8, from one key with the
JAX initial parameters carried across, within 1e-8 relative to each
leaf's (and metric's) largest entry, in both key-stream modes (measured
here ~1e-14: the two packages collect the same experience and take the same
minibatches, and differ by summation order only).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.utils import rl as jrl
from exciting_environments_torch.utils import rl as prl
from exciting_environments_torch.utils.convert import agent_params_from_numpy, tree_to_numpy

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-12, atol=1e-12)
CFG = dict(n_steps=16, n_epochs=2, n_minibatches=4, max_episode_steps=32)


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, torch.as_tensor(np.asarray(k).astype(np.int64))


def _pair(batch=8):
    return (J.Pendulum(batch_size=batch, tau=2e-2, control_state=["theta"]),
            P.Pendulum(batch_size=batch, tau=2e-2, control_state=["theta"], **F64))


def _leaves_close(port_tree, jax_tree, rel):
    """Each leaf within ``rel`` of the JAX leaf's largest entry."""
    jl, pl = jax.tree_util.tree_leaves(jax_tree), prl.tree_leaves(port_tree)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        a = np.asarray(a, dtype=np.float64)
        scale = max(float(np.abs(a).max()), 1e-300)
        assert float(np.abs(a - b.detach().numpy()).max()) <= rel * scale


def _metrics_close(port, ref, rel):
    for name, v in ref.items():
        v = np.asarray(v, dtype=np.float64)
        assert port[name].shape == v.shape, name
        assert float(np.abs(port[name].numpy() - v).max()) <= rel * max(float(np.abs(v).max()), 1e-300), name


def test_init_agent_matches_jax():
    je, pe = _pair()
    jk, pk = _key(3)
    _leaves_close(prl.init_agent(pe, pk), jrl.init_agent(je, jk), 1e-13)
    tree = prl.init_agent(pe, pk)
    assert set(tree) == {"actor", "log_std", "critic"} and tree["actor"][0]["w"].shape == (3, 64)


def _traj(rng, T=12, B=5, p_term=0.2, p_done=0.4):
    term = rng.random((T, B)) < p_term
    done = term | (rng.random((T, B)) < p_done)
    return {"reward": rng.normal(size=(T, B)), "value": rng.normal(size=(T, B)),
            "next_value": rng.normal(size=(T, B)), "term": term, "done": done}


@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (1.0, 1.0)])
def test_gae_matches_jax(gamma, lam):
    traj = _traj(np.random.default_rng(0))
    advs_j, rets_j = jrl._gae({k: jnp.asarray(v) for k, v in traj.items()}, gamma, lam)
    advs_p, rets_p = prl._gae({k: torch.as_tensor(v) for k, v in traj.items()}, gamma, lam)
    np.testing.assert_allclose(advs_p.numpy(), np.asarray(advs_j), **TOL)
    np.testing.assert_allclose(rets_p.numpy(), np.asarray(rets_j), **TOL)


def _jax_loss(config):
    """tests' copy of train_ppo's loss_fn (a closure there)."""
    def loss_fn(p, batch):
        mean = jrl._mlp_apply(p["actor"], batch["obs"])
        logp = jrl._log_prob(mean, p["log_std"], batch["action"])
        value = jrl._mlp_apply(p["critic"], batch["obs"])[..., 0]
        ratio = jnp.exp(logp - batch["logp"])
        adv = batch["adv"]
        if config.normalize_advantage:
            adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        pg = jnp.mean(jnp.maximum(-adv * ratio, -adv * jnp.clip(ratio, 1.0 - config.clip_eps,
                                                                 1.0 + config.clip_eps)))
        v_loss = 0.5 * jnp.mean((value - batch["ret"]) ** 2)
        entropy = jnp.sum(p["log_std"] + 0.5 * math.log(2.0 * math.pi * math.e))
        approx_kl = jnp.mean((ratio - 1.0) - jnp.log(ratio))
        return pg + config.vf_coef * v_loss - config.ent_coef * entropy, (pg, v_loss, entropy, approx_kl)
    return loss_fn


def _batch(rng, params, n=64):
    obs = rng.uniform(-1.0, 1.0, (n, 3))
    mean = np.asarray(jrl._mlp_apply(params["actor"], jnp.asarray(obs)))
    action = mean + 0.8 * rng.normal(size=mean.shape)
    logp = np.asarray(jrl._log_prob(jnp.asarray(mean), params["log_std"], jnp.asarray(action)))
    logp = logp + rng.normal(0.0, 0.3, n)  # the ratio spans both sides of the clip
    return {"obs": obs, "action": action, "logp": logp, "adv": rng.normal(size=n), "ret": rng.normal(size=n)}


@pytest.mark.parametrize("normalize", [True, False])
def test_loss_gradients_and_optimizer_step_match_jax(normalize):
    je, pe = _pair()
    jk, _ = _key(1)
    params_j = jrl.init_agent(je, jk)
    params_j["log_std"] = params_j["log_std"] - 0.5
    rng = np.random.default_rng(4)
    batch = _batch(rng, params_j)
    config = jrl.PPOConfig(normalize_advantage=normalize, ent_coef=0.01)
    (loss_j, aux_j), grads_j = jax.value_and_grad(_jax_loss(config), has_aux=True)(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    params_p = agent_params_from_numpy(pe, tree_to_numpy(jax.tree_util.tree_map(np.asarray, params_j)))
    live = [leaf.clone().requires_grad_(True) for leaf in prl.tree_leaves(params_p)]
    loss_p, aux_p = prl._ppo_loss(prl.PPOConfig(**config._asdict()), prl.tree_unflatten(params_p, live),
                                  {k: torch.as_tensor(v) for k, v in batch.items()})
    grads_p = torch.autograd.grad(loss_p, live)
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j), **TOL)
    for a, b in zip(aux_p, aux_j):
        np.testing.assert_allclose(float(a.detach()), float(b), **TOL)
    _leaves_close(prl.tree_unflatten(params_p, grads_p), grads_j, 1e-12)
    ratio = np.exp(np.asarray(jrl._log_prob(jrl._mlp_apply(params_j["actor"], jnp.asarray(batch["obs"])),
                                            params_j["log_std"], jnp.asarray(batch["action"]))) - batch["logp"])
    assert (ratio < 0.8).any() and (ratio > 1.2).any()

    # three optimizer steps, the first two above the clip norm, the last below
    opt = optax.chain(optax.clip_by_global_norm(config.max_grad_norm), optax.adam(config.learning_rate))
    state = opt.init(params_j)
    adam = prl.ClippedAdam(prl.tree_leaves(params_p), config.learning_rate, config.max_grad_norm)
    pj, pp = params_j, prl.tree_leaves(params_p)
    for scale in (1.0, 3.0, 1e-3):
        g_j = jax.tree_util.tree_map(lambda g: g * scale, grads_j)
        upd, state = opt.update(g_j, state, pj)
        pj = optax.apply_updates(pj, upd)
        pp = adam.update(pp, [g * scale for g in grads_p])
        _leaves_close(prl.tree_unflatten(params_p, pp), pj, 1e-12)


@pytest.mark.parametrize("scan_iterations", [False, True], ids=["chained", "scan_iterations"])
def test_train_ppo_matches_jax(scan_iterations):
    je, pe = _pair()
    jk, pk = _key(0)
    params_j = jrl.init_agent(je, _key(42)[0])
    cfg = jrl.PPOConfig(**CFG)
    res_j = jrl.train_ppo(je, 2, key=jk, config=cfg, params=params_j, scan_iterations=scan_iterations)
    res_p = prl.train_ppo(pe, 2, key=pk, config=prl.PPOConfig(**CFG), scan_iterations=scan_iterations,
                          params=agent_params_from_numpy(pe, jax.tree_util.tree_map(np.asarray, params_j)))
    _metrics_close(res_p.metrics, res_j.metrics, 1e-8)
    _leaves_close(res_p.params, res_j.params, 1e-8)


def test_evaluate_policy_matches_jax_and_is_deterministic():
    je, pe = _pair()
    params_j = jrl.init_agent(je, _key(1)[0])
    params_p = agent_params_from_numpy(pe, jax.tree_util.tree_map(np.asarray, params_j))
    val = prl.evaluate_policy(pe, params_p, n_steps=16, max_episode_steps=32)
    assert isinstance(val, float) and np.isfinite(val)
    assert val == prl.evaluate_policy(pe, params_p, n_steps=16, max_episode_steps=32)
    ref = jrl.evaluate_policy(je, params_j, n_steps=16, max_episode_steps=32)
    np.testing.assert_allclose(val, ref, **TOL)


# ---------------------------------------------------------------------------
# the counterparts of tests/test_rl.py
# ---------------------------------------------------------------------------


def test_ppo_mechanics():
    _, pe = _pair()
    res = prl.train_ppo(pe, iterations=2, key=_key(0)[1], config=prl.PPOConfig(**CFG))
    assert set(res.metrics) == {"mean_reward", "pg_loss", "value_loss", "entropy", "approx_kl"}
    for name, v in res.metrics.items():
        assert v.shape == (2,) and bool(torch.isfinite(v).all()), name
    assert bool((res.metrics["mean_reward"] <= 0).all())
    assert set(res.params) == {"actor", "log_std", "critic"}
    assert all(bool(torch.isfinite(x).all()) and not x.requires_grad for x in prl.tree_leaves(res.params))


def test_ppo_scan_iterations_mode():
    _, pe = _pair()
    res = prl.train_ppo(pe, iterations=3, key=_key(0)[1], config=prl.PPOConfig(**CFG), scan_iterations=True)
    for name, v in res.metrics.items():
        assert v.shape == (3,) and bool(torch.isfinite(v).all()), name
    chained = prl.train_ppo(pe, iterations=3, key=_key(0)[1], config=prl.PPOConfig(**CFG))
    assert not torch.equal(res.metrics["mean_reward"], chained.metrics["mean_reward"])


def test_ppo_minibatch_validation():
    _, pe = _pair()
    with pytest.raises(ValueError, match="divisible"):
        prl.train_ppo(pe, iterations=1, key=_key(0)[1], config=prl.PPOConfig(n_steps=3, n_minibatches=7))


def test_ppo_warm_start_and_policy_mean():
    _, pe = _pair()
    params = prl.init_agent(pe, _key(3)[1])
    res = prl.train_ppo(pe, iterations=1, key=_key(0)[1], params=params,
                        config=prl.PPOConfig(n_steps=8, n_epochs=1, n_minibatches=2))
    assert not torch.equal(res.params["actor"][0]["w"], params["actor"][0]["w"])
    act = prl.policy_mean(res.params, torch.zeros((5, 3), dtype=torch.float64))
    assert act.shape == (5, 1) and bool((act.abs() <= 1.0).all())


def test_ppo_episode_boundaries():
    """With gamma = lam = 1 and a one-step time limit every step is truncated
    (never terminated): each advantage is reward + V(true successor) -
    V(obs); forcing termination drops the bootstrap."""
    _, pe = _pair(batch=4)
    params = prl.init_agent(pe, _key(0)[1])
    obs0, state0 = prl._fresh(pe, _key(2)[1])
    carry = (state0, obs0, torch.zeros(4, dtype=torch.int32))
    _, traj = prl._rollout(pe, params, carry, _key(5)[1], 6, 1, False)
    assert bool(traj["done"].all()) and not bool(traj["term"].any())
    advs, rets = prl._gae(traj, gamma=1.0, lam=1.0)
    torch.testing.assert_close(advs, traj["reward"] + traj["next_value"] - traj["value"], rtol=1e-12, atol=0)
    torch.testing.assert_close(rets, traj["reward"] + traj["next_value"], rtol=1e-12, atol=0)
    advs_t, _ = prl._gae(dict(traj, term=torch.ones_like(traj["term"])), gamma=1.0, lam=1.0)
    torch.testing.assert_close(advs_t, traj["reward"] - traj["value"], rtol=1e-12, atol=0)
