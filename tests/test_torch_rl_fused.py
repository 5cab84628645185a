"""The in-kernel PPO actor and closed-loop collection against the JAX package.

The counter hash is integer arithmetic, so its integers must be equal to the
JAX package's, bit for bit; the normal draws agree at 1e-14 (float64).  The
actor, carried across with ``actor_params_from_numpy``, runs through the
port's closed loop (the kernel's plain version on CPU tensors) and through
JAX ``tile_policy_scan`` on the same inputs, float64, B = 256, T = 12, at
rtol = atol = 1e-10.  ``RolloutCollector.collect_policy_fused`` is held
against the port's own step loop and against the JAX collector's scan branch.
"""

import re
from pathlib import Path

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
from exciting_environments_torch.utils.convert import actor_params_from_numpy, state_from_numpy

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
    uint32 literals: read them from the source (the closed-loop kernel's
    header, which its translation units share)."""
    src = (CSRC / "closed_loop.cuh").read_text()
    body = src[src.index("uint32_t mix32"):src.index("// Policy functors")]
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
