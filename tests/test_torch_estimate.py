"""The port's filters (``utils/estimate.py``: ``run_ekf`` with and without the
RTS smoother, ``run_ukf``) against the JAX package's, on CPU tensors in
float64, from the same measurement logs.

The logs come from the JAX package's environments (the filters read only
observations and actions, so no state crosses over). Port and JAX agree to
rtol 1e-9 of each leaf's largest magnitude (``_close``); the deviations
measured on an x86-64 CPU (PyTorch with MKL) are written beside each case.
The JAX tests' own assertions (the filter beats the raw sensor, reconstructs
the unmeasured fields, the smoother does not degrade, the NLL prefers the
true sensor level) are held on the port's results.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.utils import estimate as jest
from exciting_environments_torch.utils import estimate as pest

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-9
B, T, TAU = 3, 300, 2e-2
SIGMA_THETA = 0.08
PENDULUM_KW = dict(measured_fields=("theta",), process_std={"omega": 0.05})


def _close(port, ref, rtol=RTOL):
    """``|port - ref| <= rtol * max|ref|`` over the whole leaf."""
    p = port.detach().double().numpy() if isinstance(port, torch.Tensor) else np.asarray(port, np.float64)
    r = np.asarray(ref, dtype=np.float64)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(float(np.abs(r).max()), 1e-300)
    dev = float(np.abs(p - r).max())
    assert dev <= rtol * scale, (dev, scale)
    return dev


def _close_result(port, ref, fields=("means", "covs", "nll")):
    for name in fields:
        _close(getattr(port, name), getattr(ref, name))


def _circ_rmse(est, true, period=2.0):
    d = est - true
    d = d - period * np.round(d / period)
    return float(np.sqrt(np.mean(d**2)))


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


@pytest.fixture(scope="module")
def pendulum():
    """The JAX test's noisy-angle pendulum (``tests/test_estimate.py:24``):
    noisy theta measurements of an exactly known trajectory, the JAX EKF
    (smoothed) on them, and the port's environment."""
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    noisy = J.Pendulum(batch_size=B, tau=TAU, observation_noise={"theta": SIGMA_THETA})
    clean = J.Pendulum(batch_size=B, tau=TAU)
    st = noisy.vmap_reset(keys)[1]
    t = jnp.arange(T) * TAU
    actions = jnp.broadcast_to(0.3 * jnp.sin(2.0 * t)[None, :, None], (B, T, 1))
    obs_noisy = np.asarray(noisy.vmap_rollout(st, actions)[0])
    obs_true = np.asarray(clean.vmap_rollout(st, actions)[0])
    jres = jest.run_ekf(noisy, obs_noisy, actions, smooth=True, **PENDULUM_KW)
    env = P.Pendulum(batch_size=B, tau=TAU, observation_noise={"theta": SIGMA_THETA}, **F64)
    pres = pest.run_ekf(env, obs_noisy, np.asarray(actions), smooth=True, **PENDULUM_KW)
    return dict(jenv=noisy, env=env, obs=obs_noisy, true=obs_true, actions=np.asarray(actions), jres=jres,
                res=pres)


def test_ekf_and_smoother_match_jax(pendulum):
    # measured (abs / leaf max): means 4.1e-15 / 9.6, covs 2.8e-17 / 0.24, nll 1.4e-12 / 614, smoothed means
    # 4.0e-15 / 1.3, smoothed covs 2.8e-17 / 4.6e-5
    _close_result(pendulum["res"], pendulum["jres"], ("means", "covs", "nll", "smoothed_means", "smoothed_covs"))
    assert pendulum["res"].means.dtype == torch.float64


def test_ekf_without_smoothing_matches_jax_and_leaves_the_smoothed_fields_empty(pendulum):
    res = pest.run_ekf(pendulum["env"], pendulum["obs"], pendulum["actions"], **PENDULUM_KW)
    assert res.smoothed_means is None and res.smoothed_covs is None
    _close_result(res, pendulum["jres"])


def test_ekf_beats_raw_measurement_and_recovers_omega(pendulum):
    means = pendulum["res"].means.numpy()
    obs, true = pendulum["obs"], pendulum["true"]
    half = T // 2
    theta_meas = _circ_rmse(obs[:, half:, 0], true[:, half:, 0])
    theta_filt = _circ_rmse(means[:, half:, 0], true[:, half:, 0])
    assert theta_filt < 0.7 * theta_meas, (theta_filt, theta_meas)
    assert _rmse(means[:, half:, 1], true[:, half:, 1]) < 0.05
    covs = pendulum["res"].covs.numpy()
    assert np.allclose(covs, np.swapaxes(covs, -1, -2))
    assert (np.diagonal(covs, axis1=-2, axis2=-1) > -1e-12).all()


def test_rts_smoother_does_not_degrade(pendulum):
    means, smoothed = pendulum["res"].means.numpy(), pendulum["res"].smoothed_means.numpy()
    true = pendulum["true"]
    assert smoothed.shape == means.shape
    assert _circ_rmse(smoothed[:, :, 0], true[:, :, 0]) <= 1.02 * _circ_rmse(means[:, :, 0], true[:, :, 0])
    assert _circ_rmse(smoothed[:, :20, 0], true[:, :20, 0]) < _circ_rmse(means[:, :20, 0], true[:, :20, 0])


def test_ukf_matches_jax_and_agrees_with_the_ekf(pendulum):
    jres = jest.run_ukf(pendulum["jenv"], pendulum["obs"], pendulum["actions"], **PENDULUM_KW)
    res = pest.run_ukf(pendulum["env"], pendulum["obs"], pendulum["actions"], **PENDULUM_KW)
    # measured: means 5.0e-14 / 9.6, covs 5.6e-16 / 0.24, nll 2.4e-11 / 614
    _close_result(res, jres)
    means_e, means_u = pendulum["res"].means.numpy(), res.means.numpy()
    half = T // 2
    d_theta = means_e[:, half:, 0] - means_u[:, half:, 0]
    assert np.abs(d_theta - 2.0 * np.round(d_theta / 2.0)).max() < 0.05
    assert np.abs(means_e[:, half:, 1] - means_u[:, half:, 1]).max() < 0.05
    assert _rmse(means_u[:, half:, 1], pendulum["true"][:, half:, 1]) < 0.06


def test_single_trajectory_is_a_batch_of_one(pendulum):
    env, obs, actions = pendulum["env"], pendulum["obs"], pendulum["actions"]
    single = pest.run_ekf(env, obs[0], actions[0], smooth=True, **PENDULUM_KW)
    jsingle = jest.run_ekf(pendulum["jenv"], obs[0], actions[0], smooth=True, **PENDULUM_KW)
    _close_result(single, jsingle, ("means", "covs", "nll", "smoothed_means"))
    assert single.nll.shape == () and single.means.shape == (T, 2) and single.covs.shape == (T, 2, 2)
    batched = pendulum["res"]
    assert batched.nll.shape == (B,) and batched.means.shape == (B, T, 2) and batched.covs.shape == (B, T, 2, 2)
    np.testing.assert_allclose(single.means.numpy(), batched.means[0].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(single.nll.numpy(), batched.nll[0].numpy(), rtol=1e-12)


def test_nll_prefers_the_true_measurement_std(pendulum):
    def nll(sigma):
        r = pest.run_ekf(pendulum["env"], pendulum["obs"], pendulum["actions"],
                         measurement_std={"theta": sigma}, **PENDULUM_KW)
        return float(r.nll.sum())

    truth = nll(SIGMA_THETA)
    assert truth < nll(SIGMA_THETA * 20)
    assert truth < nll(SIGMA_THETA / 20)


def test_defaults_come_from_the_envs_own_noise_config(pendulum):
    env, obs, actions = pendulum["env"], pendulum["obs"], pendulum["actions"]
    a = pest.run_ekf(env, obs, actions, **PENDULUM_KW)
    b = pest.run_ekf(env, obs, actions, measurement_std={"theta": SIGMA_THETA}, **PENDULUM_KW)
    assert torch.equal(a.means, b.means) and torch.equal(a.nll, b.nll)


def test_float32_inputs_are_promoted_to_the_environments_dtype(pendulum):
    env, obs, actions = pendulum["env"], pendulum["obs"], pendulum["actions"]
    r32 = pest.run_ekf(env, obs[0].astype(np.float32), actions[0].astype(np.float32), **PENDULUM_KW)
    assert r32.means.dtype == torch.float64
    # only the float32 quantization of the inputs (measured 1.4e-7)
    assert float((r32.means - pendulum["res"].means[0]).abs().max()) < 1e-5


def test_float32_environment_filters_in_float32(pendulum):
    env32 = P.Pendulum(batch_size=B, tau=TAU, observation_noise={"theta": SIGMA_THETA}, device="cpu",
                       dtype=torch.float32)
    res = pest.run_ekf(env32, pendulum["obs"], pendulum["actions"], **PENDULUM_KW)
    assert res.means.dtype == torch.float32 and res.covs.dtype == torch.float32
    # measured 2.3e-6 from the float64 filter's means (normalized units)
    assert float((res.means.double() - pendulum["res"].means).abs().max()) < 1e-4


def test_linear_msd_filter_matches_jax_and_improves_both_fields():
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    noise = {"deflection": 0.3, "velocity": 0.3}
    jenv = J.MassSpringDamper(batch_size=B, tau=TAU, observation_noise=noise)
    clean = J.MassSpringDamper(batch_size=B, tau=TAU)
    st = jenv.vmap_reset(keys)[1]
    t = jnp.arange(T) * TAU
    actions = jnp.broadcast_to(0.5 * jnp.sin(3.0 * t)[None, :, None], (B, T, 1))
    obs_noisy = np.asarray(jenv.vmap_rollout(st, actions)[0])
    obs_true = np.asarray(clean.vmap_rollout(st, actions)[0])
    jres = jest.run_ekf(jenv, obs_noisy, actions)
    res = pest.run_ekf(P.MassSpringDamper(batch_size=B, tau=TAU, observation_noise=noise, **F64), obs_noisy,
                       np.asarray(actions))
    # measured: means 5.1e-13 / 150, covs 1.2e-19 / 6.8e-4, nll 1.1e-10 / 1.1e3
    _close_result(res, jres)
    means = res.means.numpy()
    half = T // 2
    for i in range(2):
        assert _rmse(means[:, half:, i], obs_true[:, half:, i]) < 0.6 * _rmse(obs_noisy[:, half:, i],
                                                                               obs_true[:, half:, i])


PMSM_FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")


def test_linear_pmsm_ekf_and_ukf_match_jax_and_beat_the_sensor():
    """The current observer on the stochastic linear drive (the transition
    includes the inverter hexagon and the deadtime buffer swap,
    ``tests/test_estimate.py:190``)."""
    B_, T_ = 2, 200
    sig = {"i_d": 8.0, "i_q": 8.0}
    noisy = J.PMSM(batch_size=B_, saturated=False, observation_noise=sig)
    clean = J.PMSM(batch_size=B_, saturated=False)
    keys = jax.random.split(jax.random.PRNGKey(3), B_)
    st, st_c = noisy.vmap_reset(keys)[1], clean.vmap_reset(keys)[1]
    t = jnp.arange(T_) * noisy.tau
    acts = jnp.broadcast_to(0.15 * jnp.stack([jnp.sin(300.0 * t), jnp.cos(300.0 * t)], axis=-1)[None], (B_, T_, 2))
    obs_noisy = np.asarray(noisy.vmap_rollout(st, acts)[0])
    obs_true = np.asarray(clean.vmap_rollout(st_c, acts)[0])
    kw = dict(measured_fields=("i_d", "i_q", "omega_el"), process_std={"i_d": 1.0, "i_q": 1.0})
    env = P.PMSM(batch_size=B_, saturated=False, observation_noise=sig, **F64)
    half = T_ // 2
    for jrun, prun in ((jest.run_ekf, pest.run_ekf), (jest.run_ukf, pest.run_ukf)):
        jres = jrun(noisy, obs_noisy, acts, **kw)
        res = prun(env, obs_noisy, np.asarray(acts), **kw)
        # measured: EKF means 1.4e-11 / 341, covs 4.8e-15 / 1, nll 9.1e-10 / 2.1e5; UKF means 4.7e-12,
        # covs 1.4e-13 / 0.26, nll 1.7e-8 / 2.1e5
        _close_result(res, jres)
        for field, col in (("i_d", 0), ("i_q", 1)):
            est = res.means.numpy()[:, half:, PMSM_FIELDS.index(field)]
            true, raw = obs_true[:, half:, col], obs_noisy[:, half:, col]
            assert _rmse(est, true) < 0.6 * _rmse(raw, true), field
    with pytest.raises(ValueError, match="measurable"):
        pest.run_ekf(env, obs_noisy, np.asarray(acts), measured_fields=("epsilon",))


def _edge_point(pn):
    """A normalized drive state whose denormalized currents land exactly on
    a BRUSA table node (i_d = -100 A, i_q = 50 A: the cell edge)."""
    def on_node(target, norm):
        x = 2 * (target - norm.min) / (norm.max - norm.min) - 1
        for k in range(-64, 64):
            c = x + k * np.spacing(x)
            if (c + 1) / 2 * (norm.max - norm.min) + norm.min == target:
                return c
        raise AssertionError("no float lands on the node")

    x = np.zeros(len(PMSM_FIELDS))
    x[PMSM_FIELDS.index("i_d")] = on_node(-100.0, pn.i_d)
    x[PMSM_FIELDS.index("i_q")] = on_node(50.0, pn.i_q)
    x[PMSM_FIELDS.index("omega_el")] = 0.3
    return x


def test_saturated_pmsm_jacobian_on_a_table_cell_edge_is_jaxs_one_sided_derivative():
    """The table gather is only piecewise smooth: at a node both packages
    take the cell ``floor`` picks, so the Jacobian is the upper cell's
    (the lower cell's differs by 0.038 here)."""
    jenv = J.PMSM(batch_size=1, saturated=True, motor_variant=J.MotorVariant.BRUSA)
    env = P.PMSM(batch_size=1, saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
    x = _edge_point(env.env_properties.physical_normalizations)
    u = np.array([0.2, -0.1])
    fj = jest._make_dynamics(jenv, jenv.env_properties)
    jac_j = np.asarray(jax.jacobian(fj)(jnp.asarray(x), jnp.asarray(u)))
    f_next, jac_p = pest._jacobian(pest._make_dynamics(env, env.env_properties), torch.as_tensor(x)[None],
                                   torch.as_tensor(u)[None])
    assert jac_p.shape == (1, 7, 7)
    _close(jac_p[0], jac_j)  # measured 1.8e-15 / 2.19
    _close(f_next[0], fj(jnp.asarray(x), jnp.asarray(u)))
    below = x.copy()
    below[PMSM_FIELDS.index("i_d")] -= 1e-9
    assert np.abs(np.asarray(jax.jacobian(fj)(jnp.asarray(below), jnp.asarray(u))) - jac_j).max() > 1e-2


def test_saturated_pmsm_ekf_from_a_cell_edge_matches_jax():
    B_, T_ = 2, 40
    sig = {"i_d": 3.0, "i_q": 3.0}
    kw = dict(saturated=True, motor_variant=J.MotorVariant.BRUSA)
    jenv = J.PMSM(batch_size=B_, observation_noise=sig, **kw)
    _, st = jenv.vmap_reset(jax.random.split(jax.random.PRNGKey(2), B_))
    rng = np.random.default_rng(0)
    acts = rng.uniform(-0.3, 0.3, (B_, T_, 2))
    obs = np.asarray(jenv.vmap_rollout(st, jnp.asarray(acts))[0])
    env = P.PMSM(batch_size=B_, observation_noise=sig, saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
    x0 = _edge_point(env.env_properties.physical_normalizations)
    fkw = dict(measured_fields=("i_d", "i_q", "omega_el"), process_std={"i_d": 5.0, "i_q": 5.0}, x0=x0)
    # (no smoothing: the buffer fields carry no process noise, so the
    # predicted covariance is singular and the smoother NaN, in JAX too)
    jres = jest.run_ekf(jenv, obs, acts, **fkw)
    res = pest.run_ekf(env, obs, acts, **fkw)
    # measured: means 8.0e-13 / 25.6, covs 1.1e-15 / 1, nll 1.0e-10 / 1.2e5
    _close_result(res, jres)


def test_ekf_reconstructs_induction_machine_rotor_flux_like_jax():
    """``tests/test_induction_machine.py:114``: the rotor flux is not
    measurable; the EKF rebuilds it from noisy currents alone."""
    B_, T_ = 3, 400
    sig = {"i_sd": 0.5, "i_sq": 0.5}
    noisy = J.InductionMachine(batch_size=B_, observation_noise=sig)
    clean = J.InductionMachine(batch_size=B_)
    keys = jax.random.split(jax.random.PRNGKey(5), B_)
    st, st_c = noisy.vmap_reset(keys)[1], clean.vmap_reset(keys)[1]
    w_s = float(J.InductionMachine._default_static_params()["omega"]) / 0.96
    t = jnp.arange(T_) * noisy.tau
    acts = 0.4 * jnp.broadcast_to(jnp.stack([jnp.cos(w_s * t), jnp.sin(w_s * t)], axis=-1)[None], (B_, T_, 2))
    obs_noisy = np.asarray(noisy.vmap_rollout(st, acts)[0])
    obs_true = np.asarray(clean.vmap_rollout(st_c, acts)[0])
    kw = dict(measured_fields=("i_sd", "i_sq"), process_std={"psi_rd": 0.02, "psi_rq": 0.02})
    jres = jest.run_ekf(noisy, obs_noisy, acts, **kw)
    env = P.InductionMachine(batch_size=B_, observation_noise=sig, **F64)
    res = pest.run_ekf(env, obs_noisy, np.asarray(acts), **kw)
    # measured: means 1.3e-14 / 6.9, covs 3.5e-18 / 0.11, nll 1.3e-11 / 1.5e3
    _close_result(res, jres)
    names = tuple(f.name for f in dataclasses.fields(env.PhysicalState))
    half = T_ // 2
    for field in ("psi_rd", "psi_rq"):
        k = names.index(field)
        true = obs_true[:, half:, k]
        band = float(np.sqrt(np.mean(true**2)))
        assert _rmse(res.means.numpy()[:, half:, k], true) < 0.25 * max(band, 0.05), field


def test_jacobian_is_one_block_per_instance():
    """``(B, n, n)``, each instance's block the Jacobian of its own step."""
    env = P.Pendulum(batch_size=4, tau=TAU, **F64)
    f = pest._make_dynamics(env, env.env_properties)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(-0.9, 0.9, (4, 2)))
    u = torch.as_tensor(rng.uniform(-1, 1, (4, 1)))
    fx, jac = pest._jacobian(f, x, u)
    assert jac.shape == (4, 2, 2)
    torch.testing.assert_close(fx, f(x, u), rtol=0, atol=0)
    for b in range(4):
        ref = torch.func.jacrev(lambda xx: f(xx, u[b]))(x[b])
        torch.testing.assert_close(jac[b], ref, rtol=0, atol=1e-15)


def test_validation_errors():
    env = P.Pendulum(batch_size=B, tau=TAU, **F64)
    obs, act = np.zeros((T, 3)), np.zeros((T, 1))
    with pytest.raises(ValueError, match="measured_fields"):
        pest.run_ekf(env, obs, act, measured_fields=("nope",))
    with pytest.raises(ValueError, match="process_std"):
        pest.run_ekf(env, obs, act, process_std={"nope": 0.1})
    with pytest.raises(ValueError, match="time shape"):
        pest.run_ekf(env, obs, act[:-1])
    with pytest.raises(ValueError, match="x0"):
        pest.run_ekf(env, obs, act, x0=np.zeros(5))
    with pytest.raises(ValueError, match="at least one"):
        pest.run_ekf(env, obs, act, measured_fields=())
    with pytest.raises(ValueError, match="P0"):
        pest.run_ukf(env, obs, act, P0=np.zeros((3, 3)))
    with pytest.raises(ValueError, match="action"):
        pest.run_ukf(env, obs, np.zeros((T, 2)))
    fleet = P.Pendulum(batch_size=B, tau=TAU, static_params={"l": np.array([1.0, 1.1, 1.2]), "m": 1.0, "g": 9.81},
                       **F64)
    with pytest.raises(ValueError, match="scalar env properties"):
        pest.run_ekf(fleet, obs, act)
