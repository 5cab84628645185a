"""exciting-environments-torch: the PyTorch and CUDA port of
exciting-environments-tpu.

Batched ODE environments with the same classes, registry ids and
step/reset/sim_ahead/rollout surface as the JAX package; the fused rollouts
run through hand-written CUDA kernels (``csrc/stepper.cu`` for the classic
environments, ``csrc/pmsm_stepper.cu`` for the PMSM drive) on an NVIDIA
Hopper GPU, and the closed loops (``fused_closed_loop``,
``RolloutCollector.collect_policy_fused``) with the policy inside
``csrc/closed_loop.cu`` (classic environments) or
``csrc/pmsm_closed_loop.cu`` (the PMSM drive, with the sensorless current
tiles of ``utils/foc.py``); the induction machine's field-oriented tiles and
the EESM's current tile of ``utils/foc.py`` run inside ``csrc/closed_loop.cu``.  The fast-math paths, tolerance-gated against
the exact ones, run in their own kernels: ``pendulum_fast_rollout``
(``csrc/pendulum_fast.cu``) and ``PMSM.fast_rollout``
(``csrc/pmsm_fast.cu``); ``fast_math=True`` on the classic environments runs
through the stepper and closed-loop kernels.  Data generation: excitation
signals (``ops/signals.py``), randomized fleets (``utils/randomize.py``),
the collectors of ``utils/collect.py`` (``collect_fused`` through the
stepper and PMSM kernels) and adaptive integration (``ops/adaptive.py``).
Estimation, planning and identification: ``utils/estimate.py``,
``utils/mpc.py``, ``utils/ofc.py``, ``utils/ilqr.py`` and ``utils/sysid.py``
(whose multistart fits run through the stepper and PMSM kernels);
``checkpoint`` saves states in the JAX package's ``.npz`` layout and
``profiling`` traces and times.  The batch splits over devices with
``parallel.ShardedEnv`` (one kernel launch per shard); ``GymWrapper``,
``GymnasiumVectorEnv`` and ``MujucoWrapper`` are the stateful facades.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from exciting_environments_torch.core import spaces
from exciting_environments_torch.core.classic import ClassicODEEnvironment
from exciting_environments_torch.core.env import CoreEnvironment
from exciting_environments_torch.core.registration import EnvironmentRegistry
from exciting_environments_torch.models import (
    EESM,
    PMSM,
    Acrobot,
    CartPole,
    FluidTank,
    InductionMachine,
    MassSpringDamper,
    MotorVariant,
    Pendulum,
    VanDerPol,
)
from exciting_environments_torch.ops import solvers
from exciting_environments_torch.ops.kernels import pendulum_fast_rollout
from exciting_environments_torch.ops.lut import ScheduledLUT
from exciting_environments_torch.ops.policies import AffinePolicy
from exciting_environments_torch.utils import MinMaxNormalization, checkpoint, profiling, randomize
from exciting_environments_torch.utils.collect import RolloutCollector
from exciting_environments_torch.utils.foc import (
    make_eesm_current_tile,
    make_foc_tile,
    make_pmsm_saturated_sensorless_current_tile,
    make_pmsm_sensorless_current_tile,
    make_sensorless_foc,
    make_sensorless_foc_tile,
)
from exciting_environments_torch.utils.rl_fused import make_actor_tile
from exciting_environments_torch.wrappers.gym import GymWrapper


def __getattr__(name):
    # MujucoWrapper / GymnasiumVectorEnv import mujoco / gymnasium lazily so
    # the core package stays usable without the optional extras.
    if name == "MujucoWrapper":
        from exciting_environments_torch.wrappers.mujoco import MujucoWrapper

        return MujucoWrapper
    if name == "GymnasiumVectorEnv":
        from exciting_environments_torch.wrappers.gymnasium_vector import GymnasiumVectorEnv

        return GymnasiumVectorEnv
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
