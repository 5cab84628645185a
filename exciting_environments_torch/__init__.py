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
tiles of ``utils/foc.py``).  The fast-math paths, tolerance-gated against
the exact ones, run in their own kernels: ``pendulum_fast_rollout``
(``csrc/pendulum_fast.cu``) and ``PMSM.fast_rollout``
(``csrc/pmsm_fast.cu``); ``fast_math=True`` on the classic environments runs
through the stepper and closed-loop kernels.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from exciting_environments_torch.core import spaces
from exciting_environments_torch.core.classic import ClassicODEEnvironment
from exciting_environments_torch.core.env import CoreEnvironment
from exciting_environments_torch.core.registration import EnvironmentRegistry
from exciting_environments_torch.models import PMSM, CartPole, MassSpringDamper, MotorVariant, Pendulum
from exciting_environments_torch.ops import solvers
from exciting_environments_torch.ops.kernels import pendulum_fast_rollout
from exciting_environments_torch.ops.lut import ScheduledLUT
from exciting_environments_torch.ops.policies import AffinePolicy
from exciting_environments_torch.utils import MinMaxNormalization
from exciting_environments_torch.utils.collect import RolloutCollector
from exciting_environments_torch.utils.foc import (
    make_pmsm_saturated_sensorless_current_tile,
    make_pmsm_sensorless_current_tile,
)
from exciting_environments_torch.utils.rl_fused import make_actor_tile
