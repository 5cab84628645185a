"""Sensorless field-oriented control of the induction machine through the
port's ``utils/ofc.py::run_output_feedback_controller``: the runner cases of
``tests/test_foc.py`` (``:57``, ``:72``, ``:83``) on CPU tensors in float64;
the field-weakening case (``:117``) is
``tests/test_torch_ofc_weakening.py``.

A fleet with noisy current sensors, a 4-state EKF rebuilding the rotor flux,
and ``utils/foc.py::make_sensorless_foc`` on the belief: the 4,000-step run
from rest is held against the JAX package's from the same keys (sensor draws
within ``erfinv``'s last bits; rtol 1e-9 of each leaf's largest magnitude,
the deviations measured on an x86-64 CPU (PyTorch with MKL) beside it), then
to the JAX tests' setpoint and orientation assertions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.utils import foc as jfoc
from exciting_environments_tpu.utils import ofc as jofc
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import foc as pfoc
from exciting_environments_torch.utils import ofc as pofc

F64 = dict(device="cpu", dtype=torch.float64)
B = 8
PSI_REF = 0.7
TORQUE_REF = 8.0
N_STEPS = 4000
FIELDS = ("i_sd", "i_sq", "psi_rd", "psi_rq")
KW = dict(measured_fields=("i_sd", "i_sq"), process_std={"psi_rd": 0.02, "psi_rq": 0.02})


def _from_rest(jplant, plant, batch, seed):
    """Both packages' keyed resets of the plant (the same keys and draws),
    the machine then at rest with zero flux."""
    jk = jax.random.PRNGKey(seed)
    _, js = jplant.vmap_reset(jax.random.split(jk, batch))
    _, ps = plant.vmap_reset(prng.split(torch.as_tensor(np.asarray(jk).astype(np.int64)), batch))
    with jstructures.copy_and_mutate(js, validate=False) as js:
        for name in FIELDS:
            setattr(js.physical_state, name, jnp.zeros(batch))
    for name in FIELDS:
        setattr(ps.physical_state, name, torch.zeros(batch, dtype=torch.float64))
    return js, ps


@pytest.fixture(scope="module")
def foc_run():
    noise = {"i_sd": 0.3, "i_sq": 0.3}
    jplant, jmodel = J.InductionMachine(batch_size=B, observation_noise=noise), J.InductionMachine(batch_size=B)
    plant = P.InductionMachine(batch_size=B, observation_noise=noise, **F64)
    model = P.InductionMachine(batch_size=B, **F64)
    js, ps = _from_rest(jplant, plant, B, 0)
    jctrl, jc0 = jfoc.make_sensorless_foc(jmodel, psi_ref=PSI_REF, torque_ref=TORQUE_REF)
    ctrl, c0 = pfoc.make_sensorless_foc(model, psi_ref=PSI_REF, torque_ref=TORQUE_REF)
    jres = jofc.run_output_feedback_controller(jplant, jmodel, js, N_STEPS, jctrl, controller_carry=jc0,
                                               x0=jnp.zeros((4,)), **KW)
    res = pofc.run_output_feedback_controller(plant, model, ps, N_STEPS, ctrl, controller_carry=c0,
                                              x0=np.zeros(4), **KW)
    return model, res, jres


def _dev(port, ref):
    p = port.detach().double().numpy()
    r = np.asarray(ref, dtype=np.float64)
    assert p.shape == r.shape
    return float(np.abs(p - r).max()), float(np.abs(r).max())


def test_foc_run_matches_jax(foc_run):
    _, res, jres = foc_run
    # measured (abs / leaf max): observations 3.1e-14 / 0.61, actions 6.2e-14 / 1.0, belief means
    # 3.2e-14 / 0.61, covs 1.1e-19 / 0.042, nll 5.8e-11 / 2.2e4; final i_sd 1.7e-13 / 4.0, i_sq 2.7e-13 / 1.7,
    # psi_rd 3.4e-14 / 0.50, psi_rq 3.1e-14 / 0.53
    for name in ("observations", "actions", "belief_means", "belief_covs", "nll"):
        dev, scale = _dev(getattr(res, name), getattr(jres, name))
        assert dev <= 1e-9 * scale, (name, dev, scale)
    for name in FIELDS:
        dev, scale = _dev(getattr(res.final_state.physical_state, name), getattr(jres.final_state.physical_state, name))
        assert dev <= 1e-9 * scale, (name, dev, scale)


def test_foc_shapes_and_feasibility(foc_run):
    _, res, _ = foc_run
    assert res.observations.shape == (B, N_STEPS, 4)
    assert res.actions.shape == (B, N_STEPS, 2)
    assert res.belief_means.shape == (B, N_STEPS, 4)
    for leaf in (res.observations, res.actions, res.belief_means, res.nll):
        assert bool(torch.isfinite(leaf).all())
    assert bool((res.actions.abs() <= 1.0).all())
    int_d, int_q, int_psi, free = res.plan
    assert int_d.shape == (B,) and bool(torch.isfinite(int_d).all())
    assert bool(free.all())


def test_foc_reaches_flux_and_torque_setpoints(foc_run):
    model, res, _ = foc_run
    phys = res.final_state.physical_state
    psi = torch.sqrt(phys.psi_rd**2 + phys.psi_rq**2).numpy()
    np.testing.assert_allclose(psi, PSI_REF, rtol=0.06)
    np.testing.assert_allclose(model.torque(res.final_state).numpy(), TORQUE_REF, rtol=0.10)


def test_foc_orients_on_estimated_flux(foc_run):
    _, res, _ = foc_run
    psi_hat = torch.sqrt(res.belief_means[:, -1, 2] ** 2 + res.belief_means[:, -1, 3] ** 2).numpy() * 1.5
    phys = res.final_state.physical_state
    np.testing.assert_allclose(psi_hat, torch.sqrt(phys.psi_rd**2 + phys.psi_rq**2).numpy(), rtol=0.08)
