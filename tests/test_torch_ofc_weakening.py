"""Field weakening of the sensorless induction-machine drive through the
port's ``utils/ofc.py::run_output_feedback_controller`` (``tests/test_foc.py:117``),
on CPU tensors in float64: 6,500 steps of the Heun plant, its own file so
that it runs beside the 4,000-step run of ``tests/test_torch_ofc_foc.py``.
"""

import numpy as np
import torch

import exciting_environments_torch as P
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import foc as pfoc
from exciting_environments_torch.utils import ofc as pofc

F64 = dict(device="cpu", dtype=torch.float64)
PSI_REF = 0.7
KW = dict(measured_fields=("i_sd", "i_sq"), process_std={"psi_rd": 0.02, "psi_rq": 0.02})


def test_foc_field_weakening_high_speed():
    """``tests/test_foc.py:117``: above base speed the weakened flux setpoint
    keeps the drive regulating inside the voltage circle (Heun: explicit
    Euler's flux mode is unstable at this speed); without weakening the
    same machine parks on the voltage limit."""
    omega_hi = 2 * np.pi * 100
    sp = P.InductionMachine._default_static_params()
    sp["omega"] = omega_hi
    plant = P.InductionMachine(batch_size=4, static_params=dict(sp), solver="heun",
                               observation_noise={"i_sd": 0.3, "i_sq": 0.3}, **F64)
    model = P.InductionMachine(batch_size=4, static_params=dict(sp), solver="heun", **F64)
    _, ps = plant.vmap_reset(prng.split(prng.PRNGKey(7, "cpu"), 4))
    for name in ("i_sd", "i_sq", "psi_rd", "psi_rq"):  # at rest, zero flux
        setattr(ps.physical_state, name, torch.zeros(4, dtype=torch.float64))
    kw = dict(KW, x0=np.zeros(4), return_trajectories=False)
    u_margin = 0.8
    ctrl, c0 = pfoc.make_sensorless_foc(model, psi_ref=PSI_REF, torque_ref=1.5, field_weakening=True,
                                        u_margin=u_margin)
    res = pofc.run_output_feedback_controller(plant, model, ps, 4000, ctrl, controller_carry=c0, **kw)
    psi_star = u_margin * 325.0 / (omega_hi * sp["l_m"] / sp["l_r"])
    phys = res.final_state.physical_state
    np.testing.assert_allclose(torch.sqrt(phys.psi_rd**2 + phys.psi_rq**2).numpy(), psi_star, rtol=0.08)
    np.testing.assert_allclose(model.torque(res.final_state).numpy(), 1.5, rtol=0.15)
    assert bool(res.plan[3].all())
    ctrl_n, c0_n = pfoc.make_sensorless_foc(model, psi_ref=PSI_REF, torque_ref=1.5)
    res_n = pofc.run_output_feedback_controller(plant, model, ps, 2500, ctrl_n, controller_carry=c0_n, **kw)
    phys_n = res_n.final_state.physical_state
    assert (torch.sqrt(phys_n.psi_rd**2 + phys_n.psi_rq**2).numpy() < 0.6).all()
    assert not bool(res_n.plan[3].all())
