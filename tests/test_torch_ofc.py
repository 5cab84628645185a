"""The port's output-feedback runners (``utils/ofc.py``) against the JAX
package's, on CPU tensors in float64, from the same states and keys.

The noisy plants draw their sensor noise from the state's keys: keys and
uniforms are bit for bit with ``jax.random``, normals within ``erfinv``'s
last bits, so the runs agree to rtol 1e-9 of each leaf's largest magnitude
(``_close``; the deviations measured on an x86-64 CPU (PyTorch with MKL)
beside each case). The Pendulum's and the induction machine's keyed resets
draw the JAX package's bits; the PMSM case carries the JAX state across
(``state_from_numpy``, keys included). The JAX tests' assertions
(``tests/test_ofc.py``, the generic and lean runner cases of
``tests/test_foc.py``) are held on the port's runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.utils import episodes as jep
from exciting_environments_tpu.utils import foc as jfoc
from exciting_environments_tpu.utils import mpc as jmpc
from exciting_environments_tpu.utils import ofc as jofc
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import episodes as pep
from exciting_environments_torch.utils import foc as pfoc
from exciting_environments_torch.utils import mpc as pmpc
from exciting_environments_torch.utils import ofc as pofc
from exciting_environments_torch.utils.convert import state_from_numpy

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-9
B = 4
TAU = 2e-2
SIGMA = 0.08
N_STEPS = 50
CFG = dict(horizon=20, n_samples=128, temperature=0.02, noise_sigma=0.5, n_iterations=2, smoothing=0.5)
PENDULUM_KW = dict(measured_fields=("theta",), process_std={"omega": 0.05})
RESULT_LEAVES = ("observations", "actions", "rewards", "belief_means", "belief_covs", "nll")


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, torch.as_tensor(np.asarray(k).astype(np.int64))


def _close(port, ref, rtol=RTOL):
    """``|port - ref| <= rtol * max|ref|`` over the whole leaf."""
    p = port.detach().double().numpy() if isinstance(port, torch.Tensor) else np.asarray(port, np.float64)
    r = np.asarray(ref, dtype=np.float64)
    assert p.shape == r.shape, (p.shape, r.shape)
    dev = float(np.abs(p - r).max())
    assert dev <= rtol * max(float(np.abs(r).max()), 1e-300), (dev, float(np.abs(r).max()))
    return dev


def _close_result(port, ref, leaves=RESULT_LEAVES):
    for name in leaves:
        _close(getattr(port, name), getattr(ref, name))


def _pendulum_setup():
    """The JAX test's plant, model and rest state (``tests/test_ofc.py:254``)
    in both packages."""
    noise = {"theta": SIGMA}
    jplant = J.Pendulum(batch_size=B, tau=TAU, control_state=["theta"], observation_noise=noise)
    jmodel = J.Pendulum(batch_size=B, tau=TAU, control_state=["theta"])
    plant = P.Pendulum(batch_size=B, tau=TAU, control_state=["theta"], observation_noise=noise, **F64)
    model = P.Pendulum(batch_size=B, tau=TAU, control_state=["theta"], **F64)
    jk, pk = _key(4)
    _, js = jep.reset_with_references(jplant, jk)
    _, ps = pep.reset_with_references(plant, pk)
    ref = np.linspace(-0.9, 0.9, B)
    with jstructures.copy_and_mutate(js, validate=False) as js:
        js.physical_state.theta = jnp.zeros(B)
        js.physical_state.omega = jnp.zeros(B)
        js.reference.theta = jnp.asarray(ref)
    ps.physical_state.theta = torch.zeros(B, dtype=torch.float64)
    ps.physical_state.omega = torch.zeros(B, dtype=torch.float64)
    ps.reference.theta = torch.as_tensor(ref)
    return (jplant, jmodel, js), (plant, model, ps)


def _run(plant, model, state, cfg, key):
    return pofc.run_output_feedback_mppi(plant, model, state, N_STEPS, key, cfg, x0=np.zeros((B, 2)), **PENDULUM_KW)


@pytest.fixture(scope="module")
def ofc_case():
    (jplant, jmodel, js), (plant, model, ps) = _pendulum_setup()
    jres = jofc.run_output_feedback_mppi(jplant, jmodel, js, N_STEPS, _key(1)[0], jmpc.MPPIConfig(**CFG),
                                         x0=jnp.zeros((B, 2)), **PENDULUM_KW)
    res = _run(plant, model, ps, pmpc.MPPIConfig(**CFG), _key(1)[1])
    return plant, model, ps, res, jres


def test_mppi_runner_matches_jax(ofc_case):
    _, _, _, res, jres = ofc_case
    # measured (abs / leaf max): observations 2.6e-15 / 0.44, actions 7.4e-14 / 1.0, rewards 6.1e-15 / 0.76,
    # belief means 1.8e-15 / 0.43, covs 2.8e-17 / 0.24, nll 8.5e-14 / 112, plan 1.2e-13 / 1.0, final theta
    # 8.0e-15 / 1.3
    _close_result(res, jres, RESULT_LEAVES + ("plan",))
    _close(res.final_state.physical_state.theta, jres.final_state.physical_state.theta)
    np.testing.assert_array_equal(res.final_state.PRNGKey.numpy(), np.asarray(jres.final_state.PRNGKey))


def test_shapes_and_feasibility(ofc_case):
    plant, _, _, res, _ = ofc_case
    assert res.observations.shape == (B, N_STEPS, len(plant.obs_description))
    assert res.actions.shape == (B, N_STEPS, 1) and res.rewards.shape == (B, N_STEPS)
    assert res.belief_means.shape == (B, N_STEPS, 2) and res.belief_covs.shape == (B, N_STEPS, 2, 2)
    assert res.nll.shape == (B,)
    for leaf in (res.observations, res.actions, res.rewards, res.belief_means, res.nll):
        assert bool(torch.isfinite(leaf).all())
    assert bool((res.actions.abs() <= 1.0).all())


def test_tracks_from_noisy_partial_measurements(ofc_case):
    plant, model, ps, res, _ = ofc_case
    res0 = _run(plant, model, ps, pmpc.MPPIConfig(**dict(CFG, n_iterations=0)), _key(1)[1])
    assert float(res.rewards.mean()) > float(res0.rewards.mean()) + 0.1
    assert float(res.rewards[:, N_STEPS // 2:].mean()) > -0.2


def test_belief_beats_raw_sensor_and_reconstructs_omega(ofc_case):
    _, model, ps, res, _ = ofc_case
    true_obs = model.vmap_rollout(ps, res.actions)[0].numpy()
    means, meas = res.belief_means.numpy(), res.observations.numpy()

    def circ_rmse(a, b):
        d = a - b
        d = d - 2.0 * np.round(d / 2.0)
        return float(np.sqrt(np.mean(d**2)))

    assert circ_rmse(means[:, :, 0], true_obs[:, :, 0]) < 0.8 * circ_rmse(meas[:, :, 0], true_obs[:, :, 0])
    assert float(np.sqrt(np.mean((means[:, :, 1] - true_obs[:, :, 1]) ** 2))) < 0.1


def test_validation_guards():
    _, (plant, model, ps) = _pendulum_setup()
    noisy_model = P.Pendulum(batch_size=B, tau=TAU, control_state=["theta"], observation_noise={"theta": SIGMA},
                             **F64)
    with pytest.raises(ValueError, match="deterministic twin"):
        pofc.run_output_feedback_mppi(plant, noisy_model, ps, 2)
    small = P.Pendulum(batch_size=2, tau=TAU, control_state=["theta"], **F64)
    with pytest.raises(ValueError, match="batch_size"):
        pofc.run_output_feedback_mppi(plant, small, ps, 2)
    with pytest.raises(ValueError, match="batched x0"):
        pofc.run_output_feedback_mppi(plant, model, ps, 2, x0=np.zeros((B, 5)))
    coarse = P.Pendulum(batch_size=B, tau=TAU * 10, control_state=["theta"], **F64)
    with pytest.raises(ValueError, match="tau"):
        pofc.run_output_feedback_mppi(plant, coarse, ps, 2)
    narrow = P.Pendulum(batch_size=B, tau=TAU, control_state=["theta"], **F64,
                        physical_normalizations={"theta": P.MinMaxNormalization(-np.pi, np.pi),
                                                 "omega": P.MinMaxNormalization(-5, 5)})
    with pytest.raises(ValueError, match="physical_normalizations"):
        pofc.run_output_feedback_mppi(plant, narrow, ps, 2)
    untracked = P.Pendulum(batch_size=B, tau=TAU, **F64)
    with pytest.raises(ValueError, match="control_state"):
        pofc.run_output_feedback_mppi(plant, untracked, ps, 2)


PMSM_FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")


def test_output_feedback_on_pmsm_drive_matches_jax():
    """``tests/test_ofc.py:136``: noisy current sensors, the EKF current
    observer through the drive's constrained step, MPPI from the belief."""
    kw = dict(batch_size=B, control_state=["i_d", "i_q"], tau=1e-4)
    noise = {"i_d": 8.0, "i_q": 8.0}
    jplant, jmodel = J.PMSM(observation_noise=noise, **kw), J.PMSM(**kw)
    plant, model = P.PMSM(observation_noise=noise, **kw, **F64), P.PMSM(**kw, **F64)
    _, js = jep.reset_with_references(jplant, jax.random.PRNGKey(5))
    ps = state_from_numpy(plant, {n: np.asarray(getattr(js.physical_state, n)) for n in PMSM_FIELDS},
                          reference={n: np.asarray(getattr(js.reference, n)) for n in ("i_d", "i_q")},
                          keys=np.asarray(js.PRNGKey))
    cfg = dict(horizon=8, n_samples=32, temperature=0.02, noise_sigma=0.3, n_iterations=1, smoothing=0.3)
    fkw = dict(measured_fields=("i_d", "i_q", "omega_el"), process_std={"i_d": 1.0, "i_q": 1.0})
    jres = jofc.run_output_feedback_mppi(jplant, jmodel, js, 40, _key(6)[0], jmpc.MPPIConfig(**cfg), **fkw)

    def run(c):
        return pofc.run_output_feedback_mppi(plant, model, ps, 40, _key(6)[1], pmpc.MPPIConfig(**c), **fkw)

    res = run(cfg)
    # measured: observations 9.5e-13 / 1.9, actions 9.5e-13 / 1.0, rewards 4.0e-15 / 0.14, belief means
    # 1.5e-12 / 1.9, covs 2.6e-13 / 1.9, nll 2.7e-9 / 4.9e5
    _close_result(res, jres)
    assert res.belief_means.shape == (B, 40, 7)
    res0 = run(dict(cfg, n_iterations=0))
    assert float(res.rewards.mean()) > float(res0.rewards.mean()) + 0.5
    assert float(res.rewards[:, 20:].mean()) > -0.1


def test_generic_controller_runner_on_pendulum_matches_jax():
    """``tests/test_foc.py:396``: a PD law with gravity feedforward from the
    belief tracks the pendulum through noisy angle measurements."""
    (jplant, jmodel, js), (plant, model, ps) = _pendulum_setup()
    jp, pp = jmodel.env_properties.static_params, model.env_properties.static_params

    def pd_j(belief, carry, k):
        phys = belief.physical_state
        u = -jp.l * jp.m * jp.g * jnp.sin(phys.theta) - 8.0 * (phys.theta - belief.reference.theta) - 2.0 * phys.omega
        return (u / 20.0)[:, None], carry + 1

    def pd_p(belief, carry, k):
        phys = belief.physical_state
        u = (-pp.l * pp.m * pp.g * torch.sin(phys.theta) - 8.0 * (phys.theta - belief.reference.theta)
             - 2.0 * phys.omega)
        return (u / 20.0)[:, None], carry + 1

    kw = dict(measured_fields=("theta",), process_std={"omega": 0.05})
    jres = jofc.run_output_feedback_controller(jplant, jmodel, js, 60, pd_j, controller_carry=jnp.int32(0),
                                               x0=jnp.zeros((2,)), **kw)
    res = pofc.run_output_feedback_controller(plant, model, ps, 60, pd_p, controller_carry=0, x0=np.zeros(2), **kw)
    # measured: observations 1.3e-15 / 0.33, actions 3.4e-15 / 0.90, rewards 1.7e-15 / 0.76, belief means
    # 1.7e-15 / 0.35, covs 2.8e-17 / 0.24, nll 1.1e-13 / 136
    _close_result(res, jres)
    assert res.plan == 60
    assert float(res.rewards[:, 30:].mean()) > -0.2
    theta_err = res.final_state.physical_state.theta.numpy() - np.linspace(-0.9, 0.9, 4)
    assert np.abs(theta_err).max() < 0.25


def _machines(batch, noise, **kw):
    return (J.InductionMachine(batch_size=batch, observation_noise=noise, **kw), J.InductionMachine(batch_size=batch, **kw),
            P.InductionMachine(batch_size=batch, observation_noise=noise, **kw, **F64),
            P.InductionMachine(batch_size=batch, **kw, **F64))


FOC_KW = dict(measured_fields=("i_sd", "i_sq"), process_std={"psi_rd": 0.02, "psi_rq": 0.02})


def test_controller_runner_without_trajectories_matches_the_full_run_and_jax():
    """``tests/test_foc.py:436``: ``return_trajectories=False`` keeps the loop
    and drops the histories."""
    jplant, jmodel, plant, model = _machines(4, {"i_sd": 0.3})
    jk, pk = _key(3)
    _, js = jplant.vmap_reset(jax.random.split(jk, 4))
    _, ps = plant.vmap_reset(prng.split(pk, 4))
    jctrl, jc0 = jfoc.make_sensorless_foc(jmodel, psi_ref=0.5, torque_ref=2.0)
    ctrl, c0 = pfoc.make_sensorless_foc(model, psi_ref=0.5, torque_ref=2.0)
    jres = jofc.run_output_feedback_controller(jplant, jmodel, js, 40, jctrl, controller_carry=jc0,
                                               x0=jnp.zeros((4,)), **FOC_KW)
    full = pofc.run_output_feedback_controller(plant, model, ps, 40, ctrl, controller_carry=c0, x0=np.zeros(4),
                                               **FOC_KW)
    lean = pofc.run_output_feedback_controller(plant, model, ps, 40, ctrl, controller_carry=c0, x0=np.zeros(4),
                                               return_trajectories=False, **FOC_KW)
    # measured: observations 1.7e-14 / 1.1, actions 1.3e-13 / 1.0, rewards 0.0 (no control_state), belief
    # means 1.2e-13 / 12.6, covs 5.4e-19 / 0.042, nll 8.7e-11 / 5.5e4; the carry's integrators 7.9e-13 / 53,
    # 1.3e-12 / 113, 2.7e-15 / 0.44, its flag equal
    _close_result(full, jres)
    for a, b in zip(full.plan, jres.plan):
        _close(a, np.asarray(b))
    assert lean.observations is None and lean.belief_covs is None and lean.actions is None
    assert lean.rewards.shape == (4,)
    torch.testing.assert_close(lean.nll, full.nll, rtol=0, atol=0)
    torch.testing.assert_close(lean.final_state.physical_state.psi_rd, full.final_state.physical_state.psi_rd,
                               rtol=0, atol=0)
    torch.testing.assert_close(lean.rewards, full.rewards.mean(dim=1), rtol=1e-12, atol=1e-15)


def test_controller_runner_validates_like_mppi():
    """``tests/test_foc.py:464``."""
    plant = P.InductionMachine(batch_size=2, observation_noise={"i_sd": 0.3}, **F64)
    model = P.InductionMachine(batch_size=4, **F64)
    ctrl, c0 = pfoc.make_sensorless_foc(model, psi_ref=0.5, torque_ref=1.0)
    _, ps = plant.vmap_reset(prng.split(prng.PRNGKey(0, "cpu"), 2))
    with pytest.raises(ValueError, match="batch_size"):
        pofc.run_output_feedback_controller(plant, model, ps, 4, ctrl, controller_carry=c0)
