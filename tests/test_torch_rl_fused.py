"""The in-kernel PPO actor and closed-loop collection against the JAX package.

The counter hash is integer arithmetic, so its integers must be equal to the
JAX package's, bit for bit; the normal draws agree at 1e-14 (float64).  The
actor, carried across with ``actor_params_from_numpy``, runs through the
port's closed loop (the kernel's plain version on CPU tensors) and through
JAX ``tile_policy_scan`` on the same inputs, float64, B = 256, T = 12, at
rtol = atol = 1e-10.  ``RolloutCollector.collect_policy_fused`` is held
against the port's own step loop and against the JAX collector's scan branch.

The trainer: ``init_fused_agent`` within 1e-13 of the JAX package's;
``train_ppo_fused`` (both collectors; on CPU tensors the kernel collector is
the closed loop's plain version, slab for slab the scan's) against JAX
``collector="scan"`` on the Pendulum at B = 64 over 2 iterations, within
1e-8 relative to each metric's and leaf's largest entry; and the PMSM actor
(saturated BRUSA, B = 1,024, T = 4, the JAX state carried across) against
the JAX Pallas kernel in interpret mode, then ``_chunk_transitions``, GAE
and one update within 1e-10.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.utils import rl_fused as jrl
from exciting_environments_tpu.utils.collect import RolloutCollector as JRolloutCollector
from exciting_environments_tpu.utils.collect import tile_policy_scan as j_tile_policy_scan
from exciting_environments_torch.ops.kernels import closed_loop as CL
from exciting_environments_torch.utils import rl_fused as prl
from exciting_environments_torch.utils.collect import tile_policy_scan
from exciting_environments_torch.utils.convert import actor_params_from_numpy, agent_params_from_numpy, state_from_numpy

TOL = dict(rtol=1e-10, atol=1e-10)
BATCH, T = 256, 12
F64 = dict(device="cpu", dtype=torch.float64)
CSRC = Path(__file__).resolve().parents[1] / "exciting_environments_torch" / "csrc"

# ids, steps and seeds over the whole int32 range, the top bit set included
# (an arithmetic shift would copy it into the result)
_rng = np.random.default_rng(11)
IDS = np.concatenate([np.arange(64), _rng.integers(-(2**31), 2**31, 960)]).astype(np.int32)


def _jax_bits(idi, t, j, seed):
    """The JAX package's two 24-bit integers of the draw (the integer part of
    ``_hash_normal``, spelled with its own ``_mix32`` and ``_shr``)."""
    h0 = (idi * jnp.int32(jrl._KNUTH) + (jnp.asarray(t, jnp.int32) + 1) * jnp.int32(40503)
          + jnp.int32(j * 7919) + seed * jnp.int32(-2048144777))
    return jrl._shr(jrl._mix32(h0), 8), jrl._shr(jrl._mix32(h0 ^ jnp.int32(jrl._SALT)), 8)


def test_mix32_equals_jax_bit_for_bit():
    got = prl._mix32(torch.as_tensor(IDS))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrl._mix32(jnp.asarray(IDS))))


@pytest.mark.parametrize("seed", [0, 7, 2**24 - 1])
@pytest.mark.parametrize("t", [0, 5, 2**20 + 3])
def test_hash_integers_equal_jax(t, seed):
    idi_t, idi_j = torch.as_tensor(IDS), jnp.asarray(IDS)
    for j in (0, 1):
        ours = prl._hash_bits(idi_t, t, j, torch.tensor(seed, dtype=torch.int32))
        ref = _jax_bits(idi_j, t, j, jnp.int32(seed))
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert int(a.min()) >= 0 and int(a.max()) < 2**24


def test_hash_normal_matches_jax():
    idp = np.arange(4096, dtype=np.int32)
    for t, j, seed in ((0, 0, 3), (17, 1, 12345)):
        ours = prl._hash_normal(torch.as_tensor(idp), t, j, torch.tensor(seed, dtype=torch.int32), torch.float64)
        ref = jrl._hash_normal(jnp.asarray(idp), t, j, jnp.int32(seed), jnp.float64)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-14, atol=1e-14)
    assert abs(float(ours.mean())) < 0.1 and abs(float(ours.std()) - 1.0) < 0.05


def test_kernel_hash_constants_are_the_plain_versions():
    """The CUDA hash spells the plain version's signed int32 multipliers as
    uint32 literals: read them from the source (the policy header that both
    closed-loop kernels share)."""
    src = (CSRC / "policy_laws.cuh").read_text()
    body = src[src.index("uint32_t mix32"):src.index("// Four values from")]
    literals = {int(h, 16) for h in re.findall(r"0x([0-9a-f]+)u", body)}
    expected = {c & 0xFFFFFFFF for c in (prl._M1, prl._M2, prl._KNUTH, prl._SALT, prl._SEED_MUL)}
    assert literals == expected
    assert prl._SEED_MUL == -2048144777 and prl._SALT == jrl._SALT and prl._KNUTH == jrl._KNUTH


def _actor_tree(n_obs, hidden=(16, 16), n_action=1, seed=0, log_std=np.log(0.3), stream_seed=1234.0):
    """Actor weights from a numpy seed in the JAX package's layout."""
    rng = np.random.default_rng(seed)
    sizes = (n_obs, *hidden, n_action)
    layers = [{"w": rng.normal(0.0, 1.0 / np.sqrt(m), (m, n)), "b": rng.normal(0.0, 0.1, n)}
              for m, n in zip(sizes[:-1], sizes[1:])]
    return {"actor": layers, "log_std": np.full(n_action, log_std), "seed": np.float64(stream_seed)}


def _pair(batch=BATCH, **kwargs):
    return (J.Pendulum(batch_size=batch, control_state=["theta"], **kwargs),
            P.Pendulum(batch_size=batch, control_state=["theta"], **F64, **kwargs))


def _states(je, pe, seed):
    rng = np.random.default_rng(seed)
    x0 = {n: rng.uniform(-1.0, 1.0, pe.batch_size) for n in pe._ode_state_fields}
    refs = {"theta": rng.uniform(-1.5, 1.5, pe.batch_size)}
    _, js = je.vmap_reset()
    with jstructures.copy_and_mutate(js) as js:
        for n, v in x0.items():
            setattr(js.physical_state, n, jnp.asarray(v))
        js.reference.theta = jnp.asarray(refs["theta"])
    return js, state_from_numpy(pe, x0, reference=refs)


def _jax_tree(tree):
    return {"actor": [{k: jnp.asarray(v) for k, v in layer.items()} for layer in tree["actor"]],
            "log_std": jnp.asarray(tree["log_std"]), "seed": jnp.asarray(tree["seed"])}


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize("deterministic", [True, False], ids=["deterministic", "exploring"])
def test_actor_matches_jax_make_actor_tile_through_the_closed_loop(deterministic):
    je, pe = _pair(tau=2e-2)
    js, ps = _states(je, pe, 0)
    tree = _actor_tree(3)
    j_tile, j_c0 = jrl.make_actor_tile(je, deterministic=deterministic)
    obs_j, acts_j, _, last_j, fc_j = j_tile_policy_scan(je, js, T, j_tile, _jax_tree(tree), True,
                                                        policy_carry=j_c0)
    p_tile, p_c0 = P.make_actor_tile(pe, deterministic=deterministic)
    params = actor_params_from_numpy(pe, tree)
    obs_p, acts_p, last_p, fc_p = pe.fused_closed_loop(ps, p_tile, T, obs_stride=1, policy_params=params,
                                                       policy_carry=p_c0)
    _close(obs_p, obs_j)
    _close(acts_p, acts_j)
    _close(last_p.physical_state.omega, last_j.physical_state.omega)
    assert torch.equal(fc_p[0], p_c0[0]) and np.array_equal(np.asarray(fc_j[0]), fc_p[0].numpy())
    # exploration moves the actions off the mean, and the clamp holds
    assert float(acts_p.abs().max()) <= 1.0
    mean_only = pe.fused_closed_loop(ps, P.make_actor_tile(pe, deterministic=True)[0], T, obs_stride=1,
                                     policy_params=params, policy_carry=p_c0)[1]
    assert torch.equal(acts_p, mean_only) == deterministic


def test_actor_kernel_spec_layout_and_gate():
    pe = P.Pendulum(batch_size=8, control_state=["theta"], **F64)
    tree = _actor_tree(3, hidden=(5, 4))
    params = actor_params_from_numpy(pe, tree)
    tile, _ = P.make_actor_tile(pe)
    spec = tile.kernel_spec(torch.float32, "cpu", params)
    flat = np.concatenate([np.ravel(layer[k]) for layer in tree["actor"] for k in ("w", "b")]
                          + [tree["log_std"], [tree["seed"]]])
    assert spec.flat.dtype == torch.float32 and spec.n_obs == 3 and spec.policy_id == prl.ActorPolicy.policy_id
    np.testing.assert_array_equal(spec.flat.numpy(), flat.astype(np.float32))
    assert spec.options == {"deterministic": 0, "n_layers": 3, "widths": (3, 5, 4, 1)}
    big = actor_params_from_numpy(pe, _actor_tree(3, hidden=(48, 40)))
    with pytest.raises(ValueError, match=str(prl.MAX_ACTOR_PARAMS)):
        tile.kernel_spec(torch.float32, "cpu", big)
    with pytest.raises(ValueError, match="policy_params"):
        tile.kernel_spec(torch.float32, "cpu", None)


def test_collect_policy_fused_matches_step_loop_and_jax():
    """Rewards and flags on the kernel path's reconstructed states equal
    those of the port's own loop of env.step, and the JAX collector's."""
    je, pe = _pair(tau=2e-2)
    js, ps = _states(je, pe, 1)
    tree = _actor_tree(3, seed=2)
    p_tile, p_c0 = P.make_actor_tile(pe)
    params = actor_params_from_numpy(pe, tree)
    batch, final, fc = P.RolloutCollector(pe).collect_policy_fused(p_tile, ps, T, policy_params=params,
                                                                   policy_carry=p_c0)
    assert tuple(batch.observations.shape) == (BATCH, T, 3) and tuple(batch.rewards.shape) == (BATCH, T, 1)

    obs_s, acts_s, traj_s, last_s, _ = tile_policy_scan(pe, ps, T, p_tile, params, True, policy_carry=p_c0)
    props = pe._props_for(pe.env_properties, 1)
    reward_s = pe.generate_reward(traj_s, acts_s, props)
    assert torch.equal(batch.observations, obs_s) and torch.equal(batch.actions, acts_s)
    assert torch.equal(batch.rewards, reward_s)
    assert torch.equal(batch.terminated, pe.generate_terminated(traj_s, reward_s, props))
    assert torch.equal(batch.truncated, pe.generate_truncated(traj_s, props))
    assert torch.equal(final.physical_state.theta, last_s.physical_state.theta)

    j_tile, j_c0 = jrl.make_actor_tile(je)
    jbatch, jfinal, jfc = JRolloutCollector(je).collect_policy_fused(j_tile, js, T, policy_params=_jax_tree(tree),
                                                                     policy_carry=j_c0)
    for name in ("observations", "actions", "rewards"):
        _close(getattr(batch, name), getattr(jbatch, name))
    for name in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name)))
    _close(final.physical_state.theta, jfinal.physical_state.theta)
    np.testing.assert_array_equal(fc[0].numpy(), np.asarray(jfc[0]))


def test_collect_policy_fused_with_affine_pd_law():
    """The stateless collector path, with an AffinePolicy, against the JAX
    collector with the equivalent PD tile."""
    je, pe = _pair()
    js, ps = _states(je, pe, 3)
    batch, final = P.RolloutCollector(pe).collect_policy_fused(P.AffinePolicy([[-0.9, -0.25, 0.9]]), ps, T)
    jbatch, jfinal = JRolloutCollector(je).collect_policy_fused(
        lambda obs, t: (-0.9 * obs[0] + -0.25 * obs[1] + 0.9 * obs[2],), js, T)
    for name in ("observations", "actions", "rewards"):
        _close(getattr(batch, name), getattr(jbatch, name))
    _close(final.physical_state.omega, jfinal.physical_state.omega)


def test_collector_out_of_scope_raises():
    from exciting_environments_torch.utils import MinMaxNormalization

    pe = P.Pendulum(batch_size=8, control_state=["theta"],
                    action_normalizations={"torque": MinMaxNormalization(min=-20, max=np.full(8, 30.0))}, **F64)
    _, ps = pe.vmap_reset()
    ps.reference.theta = torch.zeros(8, dtype=torch.float64)
    assert not CL.supports_fused_closed_loop(pe)
    with pytest.raises(ValueError, match="scope"):
        P.RolloutCollector(pe).collect_policy_fused(P.AffinePolicy([[-0.9, -0.25, 0.9]]), ps, 4)


# ---------------------------------------------------------------------------
# the trainer: init_fused_agent, the collectors, _chunk_transitions and
# train_ppo_fused against the JAX package (float64, the initial parameters
# carried across), and the counterparts of tests/test_rl_fused.py
# ---------------------------------------------------------------------------


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, torch.as_tensor(np.asarray(k).astype(np.int64))


def _rel_close(port, ref, rel):
    ref = np.asarray(ref, dtype=np.float64)
    port = port.detach().double().numpy()
    assert port.shape == ref.shape
    assert float(np.abs(port - ref).max()) <= rel * max(float(np.abs(ref).max()), 1e-300)


def _jax_fused_loss(config):
    """tests' copy of train_ppo_fused's masked loss_fn (a closure there)."""
    import math

    def loss_fn(p, batch):
        mean = jrl._mlp_apply(p["actor"], batch["obs"])
        logp = jrl._log_prob(mean, p["log_std"], batch["action"])
        value = jrl._mlp_apply(p["critic"], batch["obs"])[..., 0]
        ratio = jnp.exp(logp - batch["logp"])
        adv, m = batch["adv"], batch["mask"]
        w = m / (jnp.sum(m) + 1e-8)
        mu = jnp.sum(adv * w)
        adv = (adv - mu) / (jnp.sqrt(jnp.sum((adv - mu) ** 2 * w)) + 1e-8)
        pg = jnp.sum(w * jnp.maximum(-adv * ratio, -adv * jnp.clip(ratio, 1.0 - config.clip_eps,
                                                                    1.0 + config.clip_eps)))
        v_loss = 0.5 * jnp.sum(w * (value - batch["ret"]) ** 2)
        entropy = jnp.sum(p["log_std"] + 0.5 * math.log(2.0 * math.pi * math.e))
        return pg + config.vf_coef * v_loss - config.ent_coef * entropy
    return loss_fn


def test_init_fused_agent_matches_jax_and_gates_the_actor():
    je, pe = _pair(batch=8)
    jk, pk = _key(42)
    ref = jrl.init_fused_agent(je, jk)
    ours = prl.init_fused_agent(pe, pk)
    for a, b in zip(jax.tree_util.tree_leaves(ref), prl.tree_leaves(ours)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-13, atol=1e-13)
    assert ours["actor"][0]["w"].shape == (3, 16) and ours["critic"][0]["w"].shape == (3, 64)
    with pytest.raises(ValueError, match="parameters"):
        prl.init_fused_agent(pe, pk, prl.FusedPPOConfig(hidden=(128, 128)))


def test_kernel_and_scan_collectors_give_the_same_slabs():
    """On CPU tensors the kernel collector is the closed loop's plain version:
    its slabs equal the step loop's, exactly."""
    _, pe = _pair(batch=64)
    params = prl.init_fused_agent(pe, _key(1)[1])
    tile, carry0 = prl.make_actor_tile(pe)
    _, state0 = prl.episodes.reset_with_references(pe, _key(2)[1])
    ap = {"actor": params["actor"], "log_std": params["log_std"], "seed": torch.tensor(7.0, dtype=torch.float64)}
    k = prl._collect_chunk(pe, ap, state0, tile, carry0, 16, "kernel")
    s = prl._collect_chunk(pe, ap, state0, tile, carry0, 16, "scan")
    for a, b in zip(k[:2], s[:2]):
        assert torch.equal(a, b)
    assert torch.equal(k[2].physical_state.theta, s[2].physical_state.theta)
    with pytest.raises(ValueError, match="collector"):
        prl._collect_chunk(pe, ap, state0, tile, carry0, 16, "loop")


@pytest.mark.parametrize("collector", ["kernel", "scan"])
def test_train_ppo_fused_matches_jax_scan(collector):
    je, pe = _pair(batch=64)
    cfg = dict(chunk_steps=16, n_chunks=2, n_minibatches=4, n_epochs=2)
    p0 = jrl.init_fused_agent(je, jax.random.PRNGKey(42), jrl.FusedPPOConfig(**cfg))
    jk, pk = _key(0)
    res_j = jrl.train_ppo_fused(je, 2, key=jk, config=jrl.FusedPPOConfig(**cfg), params=p0, collector="scan")
    res_p = prl.train_ppo_fused(pe, 2, key=pk, config=prl.FusedPPOConfig(**cfg), collector=collector,
                                params=agent_params_from_numpy(pe, jax.tree_util.tree_map(np.asarray, p0)))
    for name, v in res_j.metrics.items():
        _rel_close(res_p.metrics[name], v, 1e-8)
    for a, b in zip(jax.tree_util.tree_leaves(res_j.params), prl.tree_leaves(res_p.params)):
        _rel_close(b, a, 1e-8)


def test_pmsm_actor_chunk_and_update_match_the_jax_kernel():
    """Saturated BRUSA at B = 1,024, T = 4: the port's actor closed loop (the
    kernel's plain version) against the JAX Pallas kernel in interpret mode
    from the same state, then _chunk_transitions, GAE and one update (the
    masked loss's gradient and an optax step), within 1e-10."""
    import optax

    B, T = 1024, 4
    kw = dict(batch_size=B, saturated=True, control_state=["i_d", "i_q"])
    je = J.PMSM(motor_variant=J.MotorVariant.BRUSA, **kw)
    pe = P.PMSM(motor_variant=P.MotorVariant.BRUSA, **kw, **F64)
    _, js = jrl.episodes.reset_with_references(je, jax.random.PRNGKey(3))
    fields = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")
    refs = {n: np.asarray(getattr(js.reference, n)) for n in ("i_d", "i_q")}
    nan = {n: np.full(B, np.nan) for n in fields if n not in refs}
    ps = state_from_numpy(pe, {n: np.asarray(getattr(js.physical_state, n)) for n in fields},
                          reference={**nan, **refs}, keys=np.asarray(js.PRNGKey))
    cfg = jrl.FusedPPOConfig(chunk_steps=T)
    p0 = jrl.init_fused_agent(je, jax.random.PRNGKey(9), cfg)
    p0["log_std"] = p0["log_std"] - 0.5
    pp = agent_params_from_numpy(pe, jax.tree_util.tree_map(np.asarray, p0))
    seed = 1234.0
    j_tile, j_c0 = jrl.make_actor_tile(je)
    j_ap = {"actor": p0["actor"], "log_std": p0["log_std"], "seed": jnp.asarray(seed)}
    obs_j, acts_j, traj_j = jrl._collect_chunk(je, j_ap, js, j_tile, j_c0, T, "kernel", True)
    p_tile, p_c0 = prl.make_actor_tile(pe)
    p_ap = {"actor": pp["actor"], "log_std": pp["log_std"], "seed": torch.tensor(seed, dtype=torch.float64)}
    obs_p, acts_p, traj_p = prl._collect_chunk(pe, p_ap, ps, p_tile, p_c0, T, "kernel")
    _rel_close(obs_p, obs_j, 1e-10)
    _rel_close(acts_p, acts_j, 1e-10)
    tr_j = jrl._chunk_transitions(je, p0, js, obs_j, acts_j, traj_j, jnp.asarray(seed))
    tr_p = prl._chunk_transitions(pe, pp, ps, obs_p, acts_p, traj_p, torch.tensor(seed, dtype=torch.float64))
    assert set(tr_p) == set(tr_j)
    for name in tr_j:
        if tr_p[name].dtype == torch.bool:
            np.testing.assert_array_equal(tr_p[name].numpy(), np.asarray(tr_j[name]))
        else:
            _rel_close(tr_p[name], tr_j[name], 1e-10)
    adv_j, ret_j = jrl._gae(tr_j, cfg.gamma, cfg.gae_lambda)
    adv_p, ret_p = prl._gae(tr_p, cfg.gamma, cfg.gae_lambda)
    _rel_close(adv_p, adv_j, 1e-10)
    N = B * T
    flat = lambda tr, adv, ret, lib: {"obs": tr["obs"].reshape(N, -1), "action": tr["action"].reshape(N, -1),
                                       "logp": tr["logp"].reshape(N), "adv": adv.reshape(N),
                                       "ret": ret.reshape(N), "mask": tr["mask"].reshape(N)}
    batch_j, batch_p = flat(tr_j, adv_j, ret_j, jnp), flat(tr_p, adv_p, ret_p, torch)
    grads_j = jax.grad(_jax_fused_loss(cfg))(p0, batch_j)
    opt = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm), optax.adam(cfg.learning_rate))
    new_j = optax.apply_updates(p0, opt.update(grads_j, opt.init(p0), p0)[0])
    adam = prl.ClippedAdam(prl.tree_leaves(pp), cfg.learning_rate, cfg.max_grad_norm)
    new_p, _ = prl._minibatch_updates(lambda p, b: prl._fused_loss(prl.FusedPPOConfig(chunk_steps=T), p, b), pp,
                                      adam, batch_p, torch.arange(N)[None])
    for a, b in zip(jax.tree_util.tree_leaves(new_j), prl.tree_leaves(new_p)):
        _rel_close(b, a, 1e-10)
    assert not torch.equal(new_p["actor"][0]["w"], pp["actor"][0]["w"])


def test_kernel_collector_out_of_scope_raises():
    from exciting_environments_torch.utils import MinMaxNormalization

    pe = P.Pendulum(batch_size=8, control_state=["theta"],
                    action_normalizations={"torque": MinMaxNormalization(min=-20, max=np.full(8, 30.0))}, **F64)
    with pytest.raises(ValueError, match="scope"):
        prl.train_ppo_fused(pe, 1, key=_key(0)[1], config=prl.FusedPPOConfig(chunk_steps=4, n_minibatches=2),
                            collector="kernel")
    res = prl.train_ppo_fused(pe, 1, key=_key(0)[1], config=prl.FusedPPOConfig(chunk_steps=4, n_minibatches=2,
                                                                                  n_epochs=1), collector="scan")
    assert bool(torch.isfinite(res.metrics["mean_reward"]).all())


def test_hash_normal_statistics():
    """The counter-based draw is standard normal across instances and
    decorrelated across steps and dims."""
    idi = torch.arange(65536, dtype=torch.int32)
    seed = torch.tensor(7, dtype=torch.int32)
    z1 = prl._hash_normal(idi, 3, 0, seed, torch.float32).numpy()
    z2 = prl._hash_normal(idi, 4, 0, seed, torch.float32).numpy()
    z3 = prl._hash_normal(idi, 3, 1, seed, torch.float32).numpy()
    assert abs(z1.mean()) < 0.02 and abs(z1.std() - 1) < 0.02
    assert abs(np.corrcoef(z1, z2)[0, 1]) < 0.02 and abs(np.corrcoef(z1, z3)[0, 1]) < 0.02
    np.testing.assert_array_equal(z1, prl._hash_normal(idi, 3, 0, seed, torch.float32).numpy())
