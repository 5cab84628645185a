"""Physics environment implementations."""

from exciting_environments_torch.models.acrobot import Acrobot
from exciting_environments_torch.models.cart_pole import CartPole
from exciting_environments_torch.models.eesm import EESM
from exciting_environments_torch.models.fluid_tank import FluidTank
from exciting_environments_torch.models.induction_machine import InductionMachine
from exciting_environments_torch.models.mass_spring_damper import MassSpringDamper
from exciting_environments_torch.models.pendulum import Pendulum
from exciting_environments_torch.models.pmsm import PMSM, MotorVariant
from exciting_environments_torch.models.van_der_pol import VanDerPol
