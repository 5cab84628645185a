"""Hand-written Hopper kernels and the one place that picks among them
(counterpart of ``exciting_environments_tpu/ops/pallas/__init__.py``).

Each call kind has one scope rule: :func:`rollout_path` for the open loop
(step mode, or sim-ahead with stepsizes given) and :func:`closed_loop_path`
for the policy-in-kernel closed loop.  Callers ask the rule for the route and
launch through the environment's own entry point (``fused_rollout``,
``fused_sim_ahead``, ``fused_closed_loop`` of ``CoreEnvironment``, ``PMSM``
or, per shard, ``ShardedEnv``); :func:`traj_rollout` names the open-loop
entry point that also returns the saved states."""

from __future__ import annotations

from .pendulum_fast import pendulum_fast_rollout
from .pmsm_fast_kernel import pmsm_fast_fused_rollout


def rollout_path(env, obs_stepsize: float = None, action_stepsize: float = None) -> str:
    """Which execution path a ``fused_rollout`` (or, with stepsizes given, a
    ``fused_sim_ahead``) call on ``env`` selects: ``"pmsm_fused"`` for the
    PMSM drive kernel, ``"fused"`` for the stepper kernel (each its plain
    version on CPU tensors), ``"scan"`` for the Python-loop fallback
    (``strict=True`` raises instead of taking it).  ``env`` may be a
    :class:`~exciting_environments_torch.parallel.mesh.ShardedEnv`, whose
    shards each take the path named."""
    from exciting_environments_torch.models.pmsm import PMSM
    from exciting_environments_torch.parallel.mesh import ShardedEnv

    from .pmsm_stepper import supports_pmsm_fused, supports_pmsm_fused_sim_ahead
    from .stepper import supports_fused_rollout, supports_fused_sim_ahead

    if isinstance(env, ShardedEnv):
        env = env.env
    sim_ahead = obs_stepsize is not None
    if isinstance(env, PMSM):
        if sim_ahead:
            in_scope = supports_pmsm_fused_sim_ahead(env, obs_stepsize, action_stepsize)
        else:
            in_scope = supports_pmsm_fused(env)
        return "pmsm_fused" if in_scope else "scan"
    if sim_ahead:
        in_scope = supports_fused_sim_ahead(env, obs_stepsize, action_stepsize)
    else:
        in_scope = supports_fused_rollout(env)
    return "fused" if in_scope else "scan"


def traj_rollout(env):
    """The open-loop entry point that returns the saved states
    (``return_traj_states=True``), by the class test of :func:`rollout_path`:
    a ``ShardedEnv``'s own ``fused_rollout`` (one launch per shard),
    ``pmsm_fused_rollout`` for a PMSM drive, ``env_fused_rollout``
    otherwise.  Each is called as ``entry(env, init_state, actions_norm,
    **kwargs)``; the caller asks :func:`rollout_path` for the scope."""
    from exciting_environments_torch.models.pmsm import PMSM
    from exciting_environments_torch.parallel.mesh import ShardedEnv

    from . import pmsm_stepper, stepper

    if isinstance(env, ShardedEnv):
        return ShardedEnv.fused_rollout
    return pmsm_stepper.pmsm_fused_rollout if isinstance(env, PMSM) else stepper.env_fused_rollout


def closed_loop_path(env):
    """Which closed-loop kernel ``env.fused_closed_loop`` launches:
    ``"pmsm_closed_loop_fused"`` (a PMSM drive in its kernel's scope),
    ``"closed_loop_fused"`` (another environment in the generic kernel's
    scope; each its plain version on CPU tensors) or ``None`` (a closed loop
    has no open-loop fallback: ``fused_closed_loop`` raises).  A
    :class:`~exciting_environments_torch.parallel.mesh.ShardedEnv` is
    answered for its whole batch; it launches the kernel named per shard."""
    from exciting_environments_torch.models.pmsm import PMSM
    from exciting_environments_torch.parallel.mesh import ShardedEnv

    from .closed_loop import supports_fused_closed_loop
    from .pmsm_closed_loop import supports_pmsm_fused_closed_loop

    if isinstance(env, ShardedEnv):
        env = env.env
    if isinstance(env, PMSM):
        return "pmsm_closed_loop_fused" if supports_pmsm_fused_closed_loop(env) else None
    return "closed_loop_fused" if supports_fused_closed_loop(env) else None
