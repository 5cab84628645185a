"""PMSM drive environment and motor presets."""

from exciting_environments_torch.models.pmsm.motor_parameters import MotorVariant
from exciting_environments_torch.models.pmsm.pmsm_env import PMSM
