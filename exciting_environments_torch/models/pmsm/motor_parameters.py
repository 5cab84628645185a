"""PMSM motor parameter presets DEFAULT, BRUSA and SEW (counterpart of
``exciting_environments_tpu/models/pmsm/motor_parameters.py``).

Each variant bundles the physical and action normalizations, the static
electrical parameters and, for the measured machines, the flux/inductance
lookup tables.  The tables ship with this package as ``.npz`` files under
``exciting_environments_torch/models/pmsm_data/``.
"""

from __future__ import annotations

import math
from copy import deepcopy
from dataclasses import fields
from enum import Enum
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.utils import MinMaxNormalization

_DATA_DIR = Path(__file__).resolve().parent.parent / "pmsm_data"


def _load_lut(name: str) -> dict:
    with np.load(_DATA_DIR / f"LUT_{name}.npz") as data:
        return {k: np.array(data[k]) for k in data.files}


@dataclass
class PhysicalNormalizations:
    u_d_buffer: object
    u_q_buffer: object
    epsilon: object
    i_d: object
    i_q: object
    omega_el: object
    torque: object


@dataclass
class ActionNormalizations:
    u_d: object
    u_q: object


@dataclass
class StaticParams:
    p: int  # number of pole pairs
    r_s: float  # stator resistance
    l_d: float  # d-axis inductance
    l_q: float  # q-axis inductance
    psi_p: float  # permanent magnet flux linkage
    u_dc: float  # DC link voltage
    deadtime: int  # actuation delay in control steps


@dataclass
class MotorParams:
    physical_normalizations: PhysicalNormalizations
    action_normalizations: ActionNormalizations
    static_params: StaticParams
    default_soft_constraints: Callable
    pmsm_lut: dict


def default_soft_constraints(self, state, action_norm, env_properties):
    """ReLU(|x| - 1) soft constraint on every normalized physical-state field."""
    physical_state_norm = self.normalize_state(state, env_properties).physical_state
    with structures.copy_and_mutate(physical_state_norm) as phys_soft_const:
        for field in fields(phys_soft_const):
            value = getattr(physical_state_norm, field.name)
            setattr(phys_soft_const, field.name, torch.relu(torch.abs(value) - 1.0))
    return phys_soft_const, None


def _normalizations(u_dc, i_d_min, i_q_max, omega_max, torque_max):
    u_max = 2 * u_dc / 3
    return (
        PhysicalNormalizations(
            u_d_buffer=MinMaxNormalization(min=-u_max, max=u_max),
            u_q_buffer=MinMaxNormalization(min=-u_max, max=u_max),
            epsilon=MinMaxNormalization(min=-math.pi, max=math.pi),
            i_d=MinMaxNormalization(min=i_d_min, max=0),
            i_q=MinMaxNormalization(min=-i_q_max, max=i_q_max),
            omega_el=MinMaxNormalization(min=0, max=omega_max),
            torque=MinMaxNormalization(min=-torque_max, max=torque_max),
        ),
        ActionNormalizations(
            u_d=MinMaxNormalization(min=-u_max, max=u_max),
            u_q=MinMaxNormalization(min=-u_max, max=u_max),
        ),
    )


def _make_brusa() -> MotorParams:
    phys, act = _normalizations(400, -250, 250, 3 * 11000 * 2 * math.pi / 60, 200)
    return MotorParams(
        physical_normalizations=phys,
        action_normalizations=act,
        static_params=StaticParams(p=3, r_s=17.932e-3, l_d=0.37e-3, l_q=1.2e-3, psi_p=65.65e-3, u_dc=400, deadtime=1),
        default_soft_constraints=default_soft_constraints,
        pmsm_lut=_load_lut("BRUSA"),
    )


def _make_sew() -> MotorParams:
    phys, act = _normalizations(550, -16, 16, 4 * 2000 / 60 * 2 * math.pi, 15)
    return MotorParams(
        physical_normalizations=phys,
        action_normalizations=act,
        static_params=StaticParams(p=4, r_s=208e-3, l_d=1.44e-3, l_q=1.44e-3, psi_p=122e-3, u_dc=550, deadtime=1),
        default_soft_constraints=default_soft_constraints,
        pmsm_lut=_load_lut("SEW"),
    )


def _make_default() -> MotorParams:
    phys, act = _normalizations(400, -250, 250, 3 * 11000 * 2 * math.pi / 60, 200)
    return MotorParams(
        physical_normalizations=phys,
        action_normalizations=act,
        static_params=StaticParams(p=3, r_s=15e-3, l_d=0.37e-3, l_q=1.2e-3, psi_p=65.6e-3, u_dc=400, deadtime=1),
        default_soft_constraints=default_soft_constraints,
        pmsm_lut=None,
    )


BRUSA = _make_brusa()
SEW = _make_sew()
DEFAULT = _make_default()


class MotorVariant(Enum):
    """Selectable motor presets; ``get_params`` returns a defensive copy."""

    DEFAULT = "DEFAULT"
    BRUSA = "BRUSA"
    SEW = "SEW"

    def get_params(self) -> MotorParams:
        return deepcopy({"BRUSA": BRUSA, "SEW": SEW, "DEFAULT": DEFAULT}[self.value])
