"""The port's system identification (``utils/sysid.py``) on CPU tensors in
float64: the JAX package's ``tests/test_sysid.py`` at its sizes and gates,
``tests/test_differentiability.py::test_parameter_gradient_system_identification``,
and parity with the JAX functions from the same inputs.

Parity tolerances (measured deviations, x86-64 CPU, beside each case):
``fit_parameters``' loss history within rtol 1e-9 of its largest entry over
50 iterations, on the Pendulum with segments and the linear PMSM;
``fisher_information`` within rtol 1e-10; ``optimize_excitation``'s first
10 objectives within rtol 1e-8.  On CPU tensors the fit runs the kernels'
plain versions through their VJPs (``RolloutVJP``, ``PmsmRolloutVJP``), the
same call that launches the kernels on the card; the gradient is held
against autograd through the eager ``vmap_sim_ahead``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.ops.signals import aprbs as japrbs
from exciting_environments_tpu.utils import sysid as jsysid
from exciting_environments_torch.core import structures
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.ops.signals import aprbs
from exciting_environments_torch.utils import sysid
from exciting_environments_torch.utils.rl import ClippedAdam, cosine_decay_schedule
from exciting_environments_torch.utils.sysid import fisher_information, fit_parameters, optimize_excitation

TAU = 1e-2
TRUE = {"l": 1.3, "m": 0.8}
F64 = dict(device="cpu", dtype=torch.float64)


def _key(seed):
    return prng.PRNGKey(seed, "cpu")


def _env():
    return P.Pendulum(batch_size=4, tau=TAU, **F64)


def _true_props(env, true=TRUE):
    sp = structures.replace(env.env_properties.static_params, **true)
    return structures.replace(env.env_properties, static_params=sp)


def _aprbs(seed, n_steps, action_dim, **kw):
    return aprbs(_key(seed), 1, n_steps, action_dim, dtype=torch.float64, **kw)[0]


def _experiment(env, n_steps=256, key=0):
    """One recorded trajectory from the 'true' plant under an APRBS excitation."""
    actions = _aprbs(key, n_steps, env.action_dim, hold_min=5, hold_max=20)
    props = _true_props(env)
    init_state = env.init_state(props)
    obs, _, _ = env.sim_ahead(init_state, actions, props, TAU, TAU)
    return actions, obs, init_state


@pytest.mark.slow
def test_fit_recovers_pendulum_params():
    env = _env()
    actions, observed, init_state = _experiment(env)
    result = fit_parameters(env, actions, observed, {"l": 1.0, "m": 1.0}, init_state=init_state, n_starts=8,
                            iterations=600)
    assert result.final_loss < 1e-8
    for name, true in TRUE.items():
        assert abs(result.params[name] - true) / true < 1e-3, (name, result.params)
    assert result.start_losses[result.best_start] == result.start_losses.min()
    assert result.losses.shape == (600,)
    assert result.start_params["l"].shape == (8,)


def test_fit_seeds_init_state_from_observation():
    env = _env()
    actions, observed, _ = _experiment(env, n_steps=128)
    result = fit_parameters(env, actions, observed, {"l": 1.1, "m": 0.9}, n_starts=4, iterations=300)
    assert abs(result.params["l"] - TRUE["l"]) / TRUE["l"] < 1e-2


def test_fit_on_finer_observation_grid():
    env = _env()
    props = _true_props(env)
    actions = _aprbs(3, 96, 1, hold_min=5, hold_max=20)
    init_state = env.init_state(props)
    obs, _, _ = env.sim_ahead(init_state, actions, props, TAU, 2 * TAU)
    assert obs.shape[0] == 2 * 96 + 1
    result = fit_parameters(env, actions, obs, {"l": 1.0, "m": 1.0}, obs_stepsize=TAU, action_stepsize=2 * TAU,
                            n_starts=4, iterations=300, segment_length=16)
    assert result.final_loss < 1e-8
    assert abs(result.params["l"] - TRUE["l"]) / TRUE["l"] < 1e-3
    with pytest.raises(ValueError, match="rows"):
        fit_parameters(env, actions, obs[:-1], {"l": 1.0}, obs_stepsize=TAU, action_stepsize=2 * TAU)


def test_fit_validation_errors():
    env = _env()
    actions = torch.zeros((8, 1), dtype=torch.float64)
    observed = torch.zeros((9, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown static parameter"):
        fit_parameters(env, actions, observed, {"length": 1.0})
    with pytest.raises(ValueError, match="strictly positive"):
        fit_parameters(env, actions, observed, {"l": -1.0})
    with pytest.raises(ValueError, match="transform"):
        fit_parameters(env, actions, observed, {"l": 1.0}, transform="sqrt")
    hetero = P.Pendulum(batch_size=4, static_params={"g": 9.81, "l": torch.ones(4, dtype=torch.float64), "m": 1.0},
                        **F64)
    with pytest.raises(ValueError, match="per-batch"):
        fit_parameters(hetero, actions, observed, {"l": 1.0})


def test_fisher_information_zero_for_unexciting_input():
    env = _env()
    still = fisher_information(env, torch.zeros((64, 1), dtype=torch.float64), ("l", "m"))
    excited = fisher_information(env, _aprbs(1, 64, 1, hold_min=4, hold_max=12), ("l", "m"))
    assert float(still.fim.abs().max()) < 1e-20
    assert torch.allclose(excited.fim, excited.fim.T)
    assert float(torch.linalg.det(excited.fim)) > 0
    assert float(torch.diagonal(excited.crlb).min()) > 0
    assert excited.names == ("l", "m")


def test_fit_on_tracking_env_masks_reference_columns():
    env = P.Pendulum(batch_size=4, tau=TAU, control_state=["theta"], **F64)
    props = _true_props(env)
    actions = _aprbs(5, 128, 1, hold_min=5, hold_max=20)
    obs, _, _ = env.sim_ahead(env.init_state(props), actions, props, TAU, TAU)
    assert bool(torch.isnan(obs[:, -1]).all())  # the theta reference column
    result = fit_parameters(env, actions, obs, {"l": 1.0, "m": 1.0}, n_starts=4, iterations=600)
    assert np.isfinite(result.final_loss)
    assert abs(result.params["l"] - TRUE["l"]) / TRUE["l"] < 1e-3


def test_grid_and_shape_validation():
    env = _env()
    actions = torch.zeros((8, 1), dtype=torch.float64)
    observed = torch.zeros((9, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="must not exceed"):
        fit_parameters(env, actions, observed, {"l": 1.0}, obs_stepsize=2 * TAU, action_stepsize=TAU)
    with pytest.raises(ValueError, match="integer"):
        fit_parameters(env, actions, observed, {"l": 1.0}, obs_stepsize=0.4 * TAU, action_stepsize=TAU)
    with pytest.raises(ValueError, match="unknown static parameter"):
        fisher_information(env, actions, ("length",))
    hetero = P.Pendulum(batch_size=4, static_params={"g": 9.81, "l": torch.ones(4, dtype=torch.float64), "m": 1.0},
                        **F64)
    with pytest.raises(ValueError, match="per-batch"):
        fisher_information(hetero, actions, ("l",))
    with pytest.raises(ValueError, match="init_actions shape"):
        optimize_excitation(env, ("l",), 16, init_actions=torch.zeros((8, 1), dtype=torch.float64))


def _pmsm_experiment(env, n_steps=256):
    sp = env.env_properties.static_params
    true = {"r_s": float(sp.r_s) * 1.4, "l_d": float(sp.l_d) * 0.75, "l_q": float(sp.l_q) * 1.2}
    props = _true_props(env, true)
    actions = _aprbs(0, n_steps, env.action_dim, hold_min=3, hold_max=12)
    obs, _, _ = env.sim_ahead(env.init_state(props), actions, props, env.tau, env.tau)
    guess = {"r_s": float(sp.r_s), "l_d": float(sp.l_d), "l_q": float(sp.l_q)}
    return actions, obs, guess, true


@pytest.mark.slow
def test_fit_recovers_pmsm_motor_parameters():
    env = P.PMSM(batch_size=4, **F64)
    actions, obs, guess, true = _pmsm_experiment(env)
    result = fit_parameters(env, actions, obs, guess, n_starts=8, iterations=500, segment_length=16)
    for name, val in true.items():
        assert abs(result.params[name] - val) / val < 1e-6, (name, result.params)


def test_optimize_excitation_increases_information():
    env = _env()
    init_actions = 0.05 * prng.normal(_key(2), (48, 1), torch.float64)
    before = fisher_information(env, init_actions, ("l", "m"))
    result = optimize_excitation(env, ("l", "m"), 48, init_actions=init_actions, iterations=40)
    assert result.actions.shape == (48, 1)
    assert float(result.actions.abs().max()) <= 1.0
    gain = float(torch.linalg.slogdet(result.fisher.fim)[1] - torch.linalg.slogdet(before.fim)[1])
    assert gain > 1.0, gain
    assert float(result.objectives[-1]) > float(result.objectives[0])


def test_optimize_excitation_a_criterion():
    env = _env()
    result = optimize_excitation(env, ("l", "m"), 32, iterations=20, criterion="a")
    assert bool(torch.isfinite(result.objectives).all())
    assert float(result.objectives[-1]) > float(result.objectives[0])
    with pytest.raises(ValueError, match="criterion"):
        optimize_excitation(env, ("l",), 8, criterion="e")


@pytest.mark.slow
def test_fit_is_robust_to_sensor_noise():
    env = _env()
    noisy = P.Pendulum(batch_size=1, tau=TAU, static_params={"g": 9.81, **TRUE},
                       observation_noise={"theta": 0.01, "omega": 0.05}, **F64)
    actions = _aprbs(0, 256, 1, hold_min=5, hold_max=20)
    obs0, st = noisy.vmap_reset(prng.split(_key(5), 1))
    obs_t, _ = noisy.vmap_rollout(st, actions[None])
    observed = torch.cat([obs0, obs_t[0]], dim=0)
    init_single = structures.map_leaves(lambda leaf: leaf[0] if isinstance(leaf, torch.Tensor) else leaf, st)
    init_single = structures.replace(init_single, PRNGKey=torch.tensor(float("nan"), dtype=torch.float64))
    result = fit_parameters(env, actions, observed, {"l": 1.0, "m": 1.0}, init_state=init_single, n_starts=8,
                            iterations=600)
    for name, true in TRUE.items():
        assert abs(result.params[name] - true) / true < 0.1, (name, result.params)


def test_parameter_gradient_system_identification():
    """``tests/test_differentiability.py:74``: recover the spring constant
    by gradient descent through the eager ``vmap_step`` loop, the properties
    a leaf of the computation."""
    true_env = P.MassSpringDamper(batch_size=4, tau=1e-2, **F64)
    _, s0 = true_env.vmap_reset(prng.split(_key(0), 4))
    actions = prng.uniform(_key(1), (4, 60, 1), torch.float64, -1.0, 1.0)
    obs_data, _ = true_env.vmap_rollout(s0, actions)  # ground truth, k = 100

    def rollout_with_k(k):
        env = copy.copy(true_env)
        env.env_properties = structures.replace(
            true_env.env_properties, static_params=structures.replace(true_env.env_properties.static_params, k=k))
        obs, _ = env.vmap_rollout(s0, actions)
        return obs

    k = torch.tensor(60.0, dtype=torch.float64)
    for _ in range(100):
        k_var = k.detach().requires_grad_(True)
        loss = torch.mean((rollout_with_k(k_var) - obs_data) ** 2)
        (g,) = torch.autograd.grad(loss, k_var)
        k = k - 120.0 * g
    assert abs(float(k) - 100.0) < 0.5, f"identified k = {float(k)}"
    assert float(loss.detach()) < 1e-4


# ---------------------------------------------------------------------------
# parity with the JAX package, and the kernels' path
# ---------------------------------------------------------------------------


def _rel(port, ref):
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(port.detach().numpy() - ref).max() / np.abs(ref).max())


def _jax_pendulum_record(n_steps, key, tracking=False):
    je = J.Pendulum(batch_size=4, tau=TAU, control_state=["theta"] if tracking else [])
    sp = jstructures.replace(je.env_properties.static_params, **TRUE)
    props = jstructures.replace(je.env_properties, static_params=sp)
    actions = japrbs(jax.random.PRNGKey(key), 1, n_steps, 1, hold_min=5, hold_max=20)[0]
    obs, _, _ = je.sim_ahead(je.init_state(props), actions, props, TAU, TAU)
    return je, actions, obs


@pytest.mark.parametrize("case", ["pendulum", "pmsm"])
def test_fit_loss_history_matches_jax(case):
    if case == "pendulum":
        je, actions, obs = _jax_pendulum_record(128, 0, tracking=True)
        pe = P.Pendulum(batch_size=4, tau=TAU, control_state=["theta"], **F64)
        guess, kw = {"l": 1.0, "m": 1.0}, dict(n_starts=4, segment_length=32)
    else:
        je = J.PMSM(batch_size=4)
        sp = je.env_properties.static_params
        true = {"r_s": float(sp.r_s) * 1.4, "l_d": float(sp.l_d) * 0.75, "l_q": float(sp.l_q) * 1.2}
        props = jstructures.replace(je.env_properties, static_params=jstructures.replace(sp, **true))
        actions = japrbs(jax.random.PRNGKey(0), 1, 64, 2, hold_min=3, hold_max=12)[0]
        obs, _, _ = je.sim_ahead(je.init_state(props), actions, props, je.tau, je.tau)
        pe = P.PMSM(batch_size=4, **F64)
        guess, kw = {"r_s": float(sp.r_s), "l_d": float(sp.l_d), "l_q": float(sp.l_q)}, dict(n_starts=4,
                                                                                            segment_length=16)
    rj = jsysid.fit_parameters(je, actions, obs, guess, iterations=50, **kw)
    rp = fit_parameters(pe, np.asarray(actions), np.asarray(obs), guess, iterations=50, **kw)
    # measured 1.5e-15 (pendulum), 6.3e-15 (pmsm)
    assert _rel(rp.losses, rj.losses) <= 1e-9
    assert _rel(rp.start_losses, rj.start_losses) <= 1e-9
    for name in guess:
        assert abs(rp.params[name] - rj.params[name]) <= 1e-9 * abs(rj.params[name])
    assert rp.best_start == rj.best_start


def test_fisher_information_matches_jax():
    je, actions, _ = _jax_pendulum_record(64, 1)
    pe = _env()
    for free in (("l", "m"), {"l": 1.1, "m": 0.7}):
        fj = jsysid.fisher_information(je, actions, free)
        fp = fisher_information(pe, np.asarray(actions), free)
        # measured 4.1e-16 and 4.4e-16
        assert _rel(fp.fim, fj.fim) <= 1e-10
        assert _rel(fp.crlb, fj.crlb) <= 1e-10
    fj = jsysid.fisher_information(je, actions, ("l", "g"), relative=False, noise_std=0.1)
    fp = fisher_information(pe, np.asarray(actions), ("l", "g"), relative=False, noise_std=0.1)
    assert _rel(fp.fim, fj.fim) <= 1e-10


def test_optimize_excitation_objectives_match_jax():
    je = J.Pendulum(batch_size=4, tau=TAU)
    init = 0.05 * jax.random.normal(jax.random.PRNGKey(2), (48, 1))
    ej = jsysid.optimize_excitation(je, ("l", "m"), 48, init_actions=init, iterations=10)
    ep = optimize_excitation(_env(), ("l", "m"), 48, init_actions=np.asarray(init), iterations=10)
    # measured 2.5e-14
    assert _rel(ep.objectives, ej.objectives) <= 1e-8
    assert _rel(ep.actions, ej.actions) <= 1e-8


def test_cosine_schedule_in_clipped_adam_matches_optax():
    """The schedule reads the count of earlier updates (0 first), as optax's
    ``scale_by_learning_rate``, and decays to ``alpha``."""
    rng = np.random.default_rng(0)
    x0, target = rng.standard_normal(3), rng.standard_normal(3)
    for alpha in (0.0, 0.2):
        sched = optax.cosine_decay_schedule(0.1, 7, alpha=alpha)
        for count in range(10):
            assert abs(cosine_decay_schedule(0.1, 7, alpha=alpha)(count) - float(sched(count))) <= 1e-17
        opt = optax.adam(sched)
        xj, state = jnp.asarray(x0), None
        state = opt.init(xj)
        xp = torch.as_tensor(x0)
        padam = ClippedAdam([xp], cosine_decay_schedule(0.1, 7, alpha=alpha))
        for _ in range(10):
            gj = 2 * (xj - target) * jnp.abs(xj)
            upd, state = opt.update(gj, state, xj)
            xj = optax.apply_updates(xj, upd)
            (xp,) = padam.update([xp], [2 * (xp - torch.as_tensor(target)) * xp.abs()])
            assert _rel(xp, xj) <= 1e-13


@pytest.mark.parametrize("case", ["pendulum", "pmsm"])
def test_fit_gradient_through_the_kernels_path_matches_eager_autograd(case):
    """One batch of starts x segments through ``fused_sim_ahead`` (the
    kernels' plain versions and their VJPs on CPU tensors; one launch on the
    card) against autograd through the eager ``vmap_sim_ahead``."""
    if case == "pendulum":
        env = _env()
        names, values = ("l", "m"), [[1.0, 1.0], [1.2, 0.7], [1.5, 0.9]]
        actions, observed, _ = _experiment(env, n_steps=64)
        tau = TAU
    else:
        env = P.PMSM(batch_size=4, **F64)
        actions, observed, guess, _ = _pmsm_experiment(env, n_steps=32)
        names = tuple(guess)
        values = [[guess[n] * f for n in names] for f in (1.0, 1.3, 0.8)]
        tau = env.tau
    n_seg, L = 4, actions.shape[0] // 4
    starts = torch.arange(n_seg) * L
    states = sysid._tile_state(env.generate_state_from_observation(observed[starts], env.env_properties), 3)
    acts = actions.reshape(n_seg, L, -1).repeat(3, 1, 1)
    targets = observed[starts[:, None] + torch.arange(L + 1)[None, :]].repeat(3, 1, 1)
    grads, sims = [], []
    for eager in (False, True):
        theta = torch.log(torch.as_tensor(values, dtype=torch.float64)).requires_grad_(True)
        sim = sysid._simulate(env, names, torch.exp(theta).repeat_interleave(n_seg, dim=0), states, acts, tau, tau,
                              eager=eager)
        (g,) = torch.autograd.grad(torch.mean((sim - targets) ** 2), theta)
        grads.append(g)
        sims.append(sim.detach())
    assert torch.equal(sims[0], sims[1]) or _rel(sims[0], sims[1].numpy()) <= 1e-15
    assert _rel(grads[0], grads[1].numpy()) <= 1e-12
