"""Physics environment implementations ported so far."""

from exciting_environments_torch.models.cart_pole import CartPole
from exciting_environments_torch.models.mass_spring_damper import MassSpringDamper
from exciting_environments_torch.models.pendulum import Pendulum
from exciting_environments_torch.models.pmsm import PMSM, MotorVariant
