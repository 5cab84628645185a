"""Hand-written Hopper kernels and their dispatch rules (counterpart of
``exciting_environments_tpu/ops/pallas/__init__.py``)."""

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

    from .pmsm_stepper import supports_pmsm_fused
    from .stepper import supports_fused_rollout, supports_fused_sim_ahead

    if isinstance(env, ShardedEnv):
        env = env.env
    sim_ahead = obs_stepsize is not None
    if isinstance(env, PMSM):
        # a stochastic sim-ahead is the Euler-Maruyama loop; step mode takes
        # the noise slab
        in_scope = supports_pmsm_fused(env) and (
            not sim_ahead or (obs_stepsize == action_stepsize and not env._has_noise))
        return "pmsm_fused" if in_scope else "scan"
    if sim_ahead:
        in_scope = supports_fused_sim_ahead(env, obs_stepsize, action_stepsize)
    else:
        in_scope = supports_fused_rollout(env)
    return "fused" if in_scope else "scan"


def select_closed_loop(env):
    """The closed-loop dispatch rule shared by
    :meth:`RolloutCollector.collect_policy_fused`: ``(kernel_fn, extra_kwargs)``
    with the PMSM closed-loop kernel for a PMSM drive in its scope, the
    generic closed-loop kernel for classic environments in its scope, and
    ``(None, {})`` otherwise (a closed loop has no open-loop fallback:
    callers raise).  A :class:`~exciting_environments_torch.parallel.mesh.ShardedEnv`
    is answered for its whole batch; its own ``fused_closed_loop`` launches
    the kernel named once per shard."""
    from exciting_environments_torch.models.pmsm import PMSM
    from exciting_environments_torch.parallel.mesh import ShardedEnv

    from .closed_loop import env_fused_closed_loop, supports_fused_closed_loop
    from .pmsm_closed_loop import pmsm_fused_closed_loop, supports_pmsm_fused_closed_loop

    if isinstance(env, ShardedEnv):
        env = env.env
    if isinstance(env, PMSM):
        return (pmsm_fused_closed_loop, {}) if supports_pmsm_fused_closed_loop(env) else (None, {})
    if not supports_fused_closed_loop(env):
        return None, {}
    return env_fused_closed_loop, {}
