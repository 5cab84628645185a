"""Hand-written Hopper kernels and their dispatch rule (counterpart of
``exciting_environments_tpu/ops/pallas/__init__.py``)."""

from __future__ import annotations


def rollout_path(env, obs_stepsize: float = None, action_stepsize: float = None) -> str:
    """Which execution path a ``fused_rollout`` (or, with stepsizes given, a
    ``fused_sim_ahead``) call on ``env`` selects: ``"fused"`` for the stepper
    kernel (its plain version on CPU tensors), ``"scan"`` for the Python-loop
    fallback (``strict=True`` raises instead of taking it)."""
    from .stepper import supports_fused_rollout, supports_fused_sim_ahead

    if obs_stepsize is not None:
        in_scope = supports_fused_sim_ahead(env, obs_stepsize, action_stepsize)
    else:
        in_scope = supports_fused_rollout(env)
    return "fused" if in_scope else "scan"
