"""Environment registry (counterpart of
``exciting_environments_tpu/core/registration.py``): the same ``"<Name>-v0"``
ids for all nine environments, behind an extensible id->class table."""

from __future__ import annotations

from enum import Enum
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(env_id: str, resolver: Callable) -> None:
    """Register an environment id; ``resolver`` returns the class lazily."""
    _REGISTRY[env_id] = resolver


def resolve(env_id: str) -> Callable:
    """Return the environment class behind an id without constructing it."""
    try:
        resolver = _REGISTRY[env_id]
    except KeyError:
        raise ValueError(f"Unknown environment: {env_id!r}. Registered: {sorted(_REGISTRY)}")
    return resolver()


def make(env_id: str, **env_kwargs):
    """Instantiate a registered environment by id string."""
    return resolve(env_id)(**env_kwargs)


def _builtin(name: str) -> Callable:
    def resolver():
        import exciting_environments_torch.models as models

        return getattr(models, name)

    return resolver


for _name in ("Pendulum", "CartPole", "Acrobot", "MassSpringDamper", "FluidTank", "PMSM", "VanDerPol",
              "InductionMachine", "EESM"):
    register(f"{_name}-v0", _builtin(_name))


class EnvironmentRegistry(Enum):
    """Enum facade over the registry (reference-compatible ids)."""

    CART_POLE = "CartPole-v0"
    MASS_SPRING_DAMPER = "MassSpringDamper-v0"
    PENDULUM = "Pendulum-v0"
    FLUID_TANK = "FluidTank-v0"
    PMSM = "PMSM-v0"
    ACROBOT = "Acrobot-v0"
    VAN_DER_POL = "VanDerPol-v0"
    INDUCTION_MACHINE = "InductionMachine-v0"
    EESM = "EESM-v0"

    def make(self, **env_kwargs):
        """Instantiate the environment class behind this registry id."""
        return make(self.value, **env_kwargs)
