"""Output-feedback control: a stochastic plant, an EKF belief and a planner
or control law (counterpart of ``exciting_environments_tpu/utils/ofc.py``).

:func:`run_output_feedback_mppi` closes the loop

    belief --MPPI plan--> action --noisy plant step--> measurement --EKF--> belief

Every control step re-plans from the belief mean (rebuilt into a full
environment state through ``_state_from_normalized_physical``), applies the
first action to the plant, and assimilates the noisy partial measurement with
one batched EKF predict/update (``utils/estimate.py::_ekf_core``) on the
model's own linearization.  :func:`run_output_feedback_controller` runs the
same composition with an explicit control law (PI cascades, LQR gains, the
sensorless field-oriented control of ``utils/foc.py::make_sensorless_foc``)
in place of the planner.  Each step is eager work over the whole batch: B
independent plant / observer / controller triples, no Python loop over
instances.

``plant`` is the environment being controlled (typically noise-configured);
``model`` is the deterministic twin the planner and the filter reason with.
They must share the batch, action, state and observation layout, ``tau``
and the normalizations; model-mismatch studies vary ``static_params``.
MPPI plans with the scan backend (``use_fused=False``), as in the JAX
package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import episodes, mpc
from exciting_environments_torch.utils.estimate import (
    _ekf_core,
    _filter_setup,
    _initial_belief,
    _make_dynamics,
    _nll_term,
    _on_env,
    _phys_names,
)

__all__ = ["OFCResult", "run_output_feedback_mppi", "run_output_feedback_controller"]


class OFCResult(NamedTuple):
    """Outcome of the output-feedback runners.

    ``observations``: the noisy measurements the controller saw, ``(B,
    n_steps, obs_dim)``.  ``actions``: applied actions ``(B, n_steps,
    action_dim)``.  ``rewards``: the PLANT's true rewards ``(B, n_steps)``.
    ``belief_means`` / ``belief_covs``: the EKF posterior after each step,
    ``(B, n_steps, n_phys)`` / ``(B, n_steps, n_phys, n_phys)``.  ``nll``:
    innovation negative log likelihood ``(B,)``.  ``final_state``: the true
    plant state after the last step.  ``plan``: the final shifted plan (the
    final controller carry for :func:`run_output_feedback_controller`).
    """

    observations: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    belief_means: torch.Tensor
    belief_covs: torch.Tensor
    nll: torch.Tensor
    final_state: object
    plan: object


def _host(leaf):
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _ofc_setup(plant, model, state, measured_fields, process_std, measurement_std, x0, P0):
    """Plant/model validation, the batched EKF step and the belief-to-state
    map of the output-feedback runners: ``(belief_to_state, ekf_step, x_b,
    P_b, zidx)``."""
    if plant.batch_size != model.batch_size or plant.action_dim != model.action_dim:
        raise ValueError(
            "plant and model must agree on batch_size/action_dim, got "
            f"({plant.batch_size}, {plant.action_dim}) vs "
            f"({model.batch_size}, {model.action_dim})"
        )
    # the EKF scales Q by sqrt(model.tau) and descales measurements with the
    # model's normalization spans; a twin on another grid or band would run
    # silently miscalibrated
    if float(plant.tau) != float(model.tau):
        raise ValueError(f"plant.tau {plant.tau} != model.tau {model.tau}")
    if _phys_names(plant) != _phys_names(model) or list(plant.control_state) != list(model.control_state):
        raise ValueError(
            "plant and model must share the physical-state layout and "
            "control_state (the observation<->belief bijection relies on it)"
        )
    for which in ("physical_normalizations", "action_normalizations"):
        p_l = structures.leaves(getattr(plant.env_properties, which))
        m_l = structures.leaves(getattr(model.env_properties, which))
        if len(p_l) != len(m_l) or any(not np.array_equal(_host(a), _host(b)) for a, b in zip(p_l, m_l)):
            raise ValueError(
                f"plant and model disagree on {which} — measurements would be "
                "descaled on the wrong normalized band"
            )
    if model._has_noise:
        raise ValueError(
            "model must be the deterministic twin (its step is the planner's "
            "candidate dynamics and the EKF transition) — construct it without "
            "process_noise/observation_noise"
        )
    B = plant.batch_size
    props = model.env_properties
    dtype, device = model.dtype, model.device
    # noise defaults come from the PLANT (the filter models the disturbances
    # actually simulated); spans and periods from the model
    _, n, midx, zidx, Q, R, periods = _filter_setup(
        model, measured_fields,
        process_std if process_std is not None else plant._process_noise,
        measurement_std if measurement_std is not None else dict(plant._observation_noise or {}),
    )
    ekf = _ekf_core(_make_dynamics(model, props), Q, R, midx, periods)
    if x0 is not None and np.ndim(x0) == 2:
        x_b = _on_env(model, x0)
        if tuple(x_b.shape) != (B, n):
            raise ValueError(f"batched x0 must have shape ({B}, {n}), got {tuple(x_b.shape)}")
        _, P0_single = _initial_belief(None, P0, n, midx, R, dtype, device)
    else:
        x0_single, P0_single = _initial_belief(x0, P0, n, midx, R, dtype, device)
        x_b = x0_single.expand(B, n)
    P_b = P0_single.expand(B, n, n)
    # references are frozen along the loop: the normalized reference columns
    # ride along with the belief into the state map
    norm_state = model.normalize_state(state, props)
    if model.control_state:
        ref_b = torch.stack([getattr(norm_state.reference, nm) for nm in model.control_state], dim=-1)
    else:
        ref_b = torch.zeros((B, 0), dtype=dtype, device=device)

    def belief_to_state(x_hat):
        return model._state_from_normalized_physical(x_hat, props, ref_norm=ref_b)

    def ekf_step(x, P, u, z, nll):
        x_new, P_new, innov, S, *_ = ekf(x, P, u, z)
        return x_new, P_new, nll + _nll_term(innov, S)

    return belief_to_state, ekf_step, x_b, P_b, zidx


def run_output_feedback_mppi(plant, model, state, n_steps: int, key=None, config: mpc.MPPIConfig = mpc.MPPIConfig(),
                             *, measured_fields=None, process_std=None, measurement_std=None, x0=None, P0=None,
                             cost_fn: Callable = None, plan=None) -> OFCResult:
    """Receding-horizon MPPI from noisy partial measurements.

    Args:
        plant: the batched environment being controlled, typically with
            ``process_noise`` / ``observation_noise``.
        model: the deterministic twin of the planner's candidates and of the
            EKF's transition (scalar properties, the filter's restriction).
        state: batched initial PLANT state; with the default tracking cost
            its references drawn (``utils.episodes.reset_with_references``)
            and, for a noisy plant, its keys usable (a keyed ``vmap_reset``).
        n_steps: control steps.
        key: a key for the MPPI draws (default ``PRNGKey(0)`` on the
            model's device).
        config: :class:`~exciting_environments_torch.utils.mpc.MPPIConfig`.
        measured_fields / process_std / measurement_std / x0 / P0: the EKF
            contract of :func:`~exciting_environments_torch.utils.estimate.run_ekf`
            (noise dicts default to the PLANT's configuration); ``x0`` also
            takes a per-instance ``(batch_size, n_phys)`` mean.
        cost_fn: optional trajectory cost (see ``mpc.mppi_plan``).
        plan: optional warm-start plan ``(B, horizon, action_dim)``.

    Returns:
        :class:`OFCResult`.
    """
    if key is None:
        key = prng.PRNGKey(0, model.device)
    B, A, H = plant.batch_size, plant.action_dim, config.horizon
    if plan is None:
        plan = torch.zeros((B, H, A), dtype=model.dtype, device=model.device)
    # setup first: its plant-vs-model batch check must fire before the plan's
    belief_to_state, ekf_step, x_hat, P, zidx = _ofc_setup(plant, model, state, measured_fields, process_std,
                                                           measurement_std, x0, P0)
    mpc._validate_plan(model, config, plan, cost_fn, state)
    nll = torch.zeros(B, dtype=model.dtype, device=model.device)
    obs, act, rew, xs, Ps = [], [], [], [], []
    for k in prng.split(key, n_steps):
        plan = mpc._plan_core(model, belief_to_state(x_hat), plan, k, config, cost_fn, use_fused=False)
        action = plan[:, 0]
        o, state, r, _, _, _ = episodes.step_with_flags(plant, state, action)
        x_hat, P, nll = ekf_step(x_hat, P, action, o[:, zidx], nll)
        plan = torch.cat([plan[:, 1:], plan[:, -1:]], dim=1)
        for hist, value in zip((obs, act, rew, xs, Ps), (o, action, r, x_hat, P)):
            hist.append(value)
    stack = lambda hist: torch.stack(hist, dim=1)
    return OFCResult(observations=stack(obs), actions=stack(act), rewards=stack(rew), belief_means=stack(xs),
                     belief_covs=stack(Ps), nll=nll, final_state=state, plan=plan)


def run_output_feedback_controller(plant, model, state, n_steps: int, controller: Callable, *, controller_carry=None,
                                   measured_fields=None, process_std=None, measurement_std=None, x0=None, P0=None,
                                   return_trajectories: bool = True) -> OFCResult:
    """Closed-loop analytic control from noisy partial measurements.

    The sibling of :func:`run_output_feedback_mppi` for explicit control
    LAWS: the controller sees only the EKF belief, never the plant state,

        belief --controller--> action --noisy plant step--> measurement --EKF--> belief

    one law evaluation, one plant step and one EKF update per control step.

    Args:
        plant / model / state / measured_fields / process_std /
            measurement_std / x0 / P0: the :func:`run_output_feedback_mppi`
            contract.
        n_steps: control steps.
        controller: ``controller(belief_state, carry, k) -> (action,
            carry)``: ``belief_state`` the belief mean as a full batched
            state (physical units, references attached), ``k`` the step
            index (a Python int), ``action`` the normalized ``(B,
            action_dim)`` command (clipped to ``[-1, 1]``), ``carry`` any
            structure threaded between steps.
        controller_carry: the initial carry (default ``None``).
        return_trajectories: with ``False`` no per-step history is kept:
            ``observations``, ``actions``, ``belief_means`` and
            ``belief_covs`` are ``None`` and ``rewards`` is the horizon-mean
            reward per instance ``(B,)``; ``nll``, ``final_state`` and the
            final carry are unchanged.  Memory then scales with the fleet,
            not the horizon.

    Returns:
        :class:`OFCResult` (``plan`` holds the final controller carry).
    """
    belief_to_state, ekf_step, x_hat, P, zidx = _ofc_setup(plant, model, state, measured_fields, process_std,
                                                           measurement_std, x0, P0)
    B, dtype, device = plant.batch_size, model.dtype, model.device
    nll = torch.zeros(B, dtype=dtype, device=device)
    rew_sum = torch.zeros(B, dtype=dtype, device=device)
    ctrl = controller_carry
    hists = ([], [], [], [], [])
    for k in range(n_steps):
        action, ctrl = controller(belief_to_state(x_hat), ctrl, k)
        action = torch.clamp(torch.as_tensor(action, dtype=dtype, device=device), -1.0, 1.0)
        o, state, r, _, _, _ = episodes.step_with_flags(plant, state, action)
        x_hat, P, nll = ekf_step(x_hat, P, action, o[:, zidx], nll)
        rew_sum = rew_sum + r
        if return_trajectories:
            for hist, value in zip(hists, (o, action, r, x_hat, P)):
                hist.append(value)
    if not return_trajectories:
        return OFCResult(observations=None, actions=None, rewards=rew_sum / n_steps, belief_means=None,
                         belief_covs=None, nll=nll, final_state=state, plan=ctrl)
    obs, act, rew, xs, Ps = (torch.stack(hist, dim=1) for hist in hists)
    return OFCResult(observations=obs, actions=act, rewards=rew, belief_means=xs, belief_covs=Ps, nll=nll,
                     final_state=state, plan=ctrl)
