"""iLQR trajectory optimization through the environment's own differentiable
step (counterpart of ``exciting_environments_tpu/utils/ilqr.py``).

Completes the planning triad of :mod:`~exciting_environments_torch.utils.mpc`:
MPPI explores by sampling, ``optimize_actions`` descends first-order
gradients, and :func:`ilqr_plan` is the second-order classic, iterative LQR
with the dynamics linearized through the environment's own step (the
construction of the EKF in :mod:`~exciting_environments_torch.utils.estimate`)
and the stage cost quadratized by a second reverse pass.

Where the JAX package ``vmap``s one iLQR per instance, the port runs ONE
batched solve over all instances:

* **linearization**: ``A`` ``(H, B, n, n)`` and ``B_u`` ``(H, B, n, m)`` at
  every step of the nominal trajectory in one reverse pass over an ``(n,
  H, B, n + m)`` copy of ``z = (x, u)`` (``estimate._jacobian``);
* **quadratization**: the gradient and Hessian ``(H, B, n + m, n + m)`` of
  the stage cost ``g(z) = l(f(x, u), u)``, from a reverse pass with
  ``create_graph=True`` and one reverse pass over an ``(n + m)``-copy
  (:func:`_grad_hessian`), the counterpart of ``jax.hessian``;
* **the backward Riccati sweep**: batched ``torch.linalg.solve`` on ``Quu +
  mu I`` with a Levenberg ``mu`` per instance;
* **the line search**: every step size rolls out at once, folded into the
  batch as ``(n_alphas, B)``; per instance the best candidate is taken only
  if it lowers the nominal cost, and ``mu`` shrinks (÷3) on an accepted
  step or grows (×10) on a rejected one.

Semantics match the JAX package: the default objective is the negative sum
of the environment's tracking rewards over the post-step states (plus the
optional ``action_cost`` energy), actions live in the normalized [-1, 1]
band and are clipped inside the forward pass, and angle-state deviations
feed the feedback gains through their shortest circular representative.
The PMSM drive's linearizations include its inverter hexagon constraint and
deadtime buffer swap.  No kernel runs here, as in the JAX package: the line
search applies time-varying feedback that no kernel computes.

Not ported: the ``ShardedEnv`` branch (``unwrap_sharded``) waits for the mesh
facade (``parallel/mesh.py``); the planner takes a plain environment.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from exciting_environments_torch.utils import mpc
from exciting_environments_torch.utils.estimate import (
    _angle_periods,
    _dynamics_fn,
    _jacobian,
    _phys_names,
    _wrap_diff,
)

__all__ = ["ilqr_plan"]


def _default_stage_cost(env, action_cost):
    """Negative environment tracking reward at the post-step state (+
    optional action energy), elementwise over leading axes:
    ``mpc._trajectory_cost``'s default, stage by stage."""

    def cost(x_next_norm, u_norm, ref_norm, props):
        state = env._state_from_normalized_physical(x_next_norm, props, ref_norm=ref_norm)
        action = env.denormalize_action(u_norm, props)
        c = -env.generate_reward(state, action, props)[..., 0]
        if action_cost:
            c = c + action_cost * torch.sum(u_norm**2, dim=-1)
        return c

    return cost


def _linearize(f, xs, us):
    """``(A, B_u)`` of ``f`` at every ``(x, u)`` of ``xs`` ``(..., n)`` and
    ``us`` ``(..., m)``: ``(..., n, n)`` and ``(..., n, m)``, from one
    reverse pass over an ``(n, ..., n + m)`` copy of ``z = (x, u)``."""
    n = xs.shape[-1]
    z = torch.cat([xs, us], dim=-1)
    _, jac = _jacobian(lambda zz, _: f(zz[..., :n], zz[..., n:]), z, z[..., :0], n_out=n)
    return jac[..., :n], jac[..., n:]


def _grad_hessian(g, z):
    """Gradient ``(..., p)`` and Hessian ``(..., p, p)`` of the per-instance
    scalar ``g(z)`` ``(...)`` at ``z`` ``(..., p)``: the gradient of a
    ``(p, ..., p)`` copy of ``z`` with its graph kept, then one reverse pass
    in which copy ``k`` seeds gradient component ``k`` (row ``k`` of the
    Hessian)."""
    p = z.shape[-1]
    with torch.enable_grad():
        zs = z.detach().expand((p,) + tuple(z.shape)).clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(g(zs).sum(), zs, create_graph=True)
        k = torch.arange(p, device=z.device)
        (rows,) = torch.autograd.grad(grad[k, ..., k].sum(), zs)
    return grad[0].detach(), rows.movedim(0, -2)


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _backward_sweep(A, Bu, grad_g, hess_g, mu):
    """The Riccati sweep from the last step to the first over the
    linearizations ``A`` ``(H, B, n, n)``, ``Bu`` ``(H, B, n, m)`` and the
    stage cost's gradient ``(H, B, n + m)`` and Hessian ``(H, B, n + m, n +
    m)``, with the Levenberg ``mu`` ``(B,)`` on ``Quu``.  Returns the
    feed-forward terms ``(H, B, m)`` and gains ``(H, B, m, n)``."""
    H, B, n, m = Bu.shape
    Vx = grad_g.new_zeros((B, n))
    Vxx = grad_g.new_zeros((B, n, n))
    eye_m = torch.eye(m, dtype=grad_g.dtype, device=grad_g.device)
    kffs, Ks = [None] * H, [None] * H
    for t in range(H - 1, -1, -1):
        Aj, Bj, gz, hz = A[t], Bu[t], grad_g[t], hess_g[t]
        AT, BT = Aj.mT, Bj.mT
        Qx = gz[:, :n] + _mv(AT, Vx)
        Qu = gz[:, n:] + _mv(BT, Vx)
        Qxx = hz[:, :n, :n] + AT @ Vxx @ Aj
        Quu = hz[:, n:, n:] + BT @ Vxx @ Bj
        Qux = hz[:, n:, :n] + BT @ Vxx @ Aj
        Quu_r = Quu + mu[:, None, None] * eye_m
        kff = -torch.linalg.solve_ex(Quu_r, Qu.unsqueeze(-1)).result.squeeze(-1)
        K = -torch.linalg.solve_ex(Quu_r, Qux).result
        KT = K.mT
        Vx = Qx + _mv(KT @ Quu, kff) + _mv(KT, Qu) + _mv(Qux.mT, kff)
        Vxx = Qxx + KT @ Quu @ K + KT @ Qux + Qux.mT @ K
        Vxx = 0.5 * (Vxx + Vxx.mT)
        kffs[t], Ks[t] = kff, K
    return torch.stack(kffs), torch.stack(Ks)


class _Problem(NamedTuple):
    """One batched planning problem in normalized coordinates: the step
    ``f(x, u)``, the stage cost ``l(x_next, u)`` (the frozen references
    bound), the start ``x0`` ``(B, n)`` and the angle periods ``(n,)``."""

    f: Callable
    l: Callable
    x0: torch.Tensor
    periods: torch.Tensor

    def stage(self, z):
        """The stage cost in ``z = (x_k, u_k)``: ``l(f(x, u), u)``."""
        n = self.x0.shape[-1]
        return self.l(self.f(z[..., :n], z[..., n:]), z[..., n:])


def _problem(env, state, action_cost, stage_cost):
    """The :class:`_Problem` of planning ``env`` from ``state``."""
    props = env.env_properties
    names = _phys_names(env)
    B, dtype, device = env.batch_size, env.dtype, env.device
    periods = torch.as_tensor(_angle_periods(env, props, names), dtype=dtype, device=device)
    cost_fn = stage_cost or _default_stage_cost(env, action_cost)
    norm_state = env.normalize_state(state, props)
    stack = lambda tree, fields: torch.stack([torch.as_tensor(getattr(tree, nm), dtype=dtype, device=device)
                                              .expand(B) for nm in fields], dim=-1)
    x0 = stack(norm_state.physical_state, names)
    ref = stack(norm_state.reference, env.control_state) if env.control_state else \
        torch.zeros((B, 0), dtype=dtype, device=device)
    dyn = _dynamics_fn(env)
    return _Problem(
        f=lambda x, u: dyn(x, u, props),
        l=lambda x_next, u: cost_fn(x_next, u, ref.expand(tuple(x_next.shape[:-1]) + tuple(ref.shape[-1:])), props),
        x0=x0,
        periods=periods,
    )


def _rollout_cost(prob, us):
    """The nominal rollout of ``us`` ``(H, B, m)`` from ``prob.x0``: the
    pre-step states ``(H, B, n)`` and the summed stage cost ``(B,)``."""
    x, J, xs = prob.x0, None, []
    for t in range(us.shape[0]):
        xs.append(x)
        x = prob.f(x, us[t])
        c = prob.l(x, us[t])
        J = c if J is None else J + c
    return torch.stack(xs), J


def _line_search(prob, xs, us, kffs, Ks, alphas):
    """Every step size at once, folded into the batch: the candidates'
    costs ``(n_alphas, B)``, pre-step states ``(n_alphas, H, B, n)`` and
    actions ``(n_alphas, H, B, m)``."""
    k = alphas.shape[0]
    x = prob.x0.expand((k,) + tuple(prob.x0.shape))
    J = prob.x0.new_zeros((k, prob.x0.shape[0]))
    xs_new, us_new = [], []
    for t in range(us.shape[0]):
        du = alphas[:, None, None] * kffs[t] + _mv(Ks[t], _wrap_diff(x - xs[t], prob.periods))
        u = torch.clamp(us[t] + du, -1.0, 1.0)
        xs_new.append(x)
        us_new.append(u)
        x = prob.f(x, u)
        J = J + prob.l(x, u)
    return J, torch.stack(xs_new, dim=1), torch.stack(us_new, dim=1)


def _iteration(prob, xs, us, J, mu, alphas):
    """One iLQR iteration over the batch: linearize and quadratize along the
    nominal ``(xs, us)``, sweep, line-search, and per instance accept the
    best candidate only if it lowers ``J``.  Returns the new ``(xs, us, J,
    mu)``."""
    A, Bu = _linearize(prob.f, xs, us)
    grad_g, hess_g = _grad_hessian(prob.stage, torch.cat([xs, us], dim=-1))
    kffs, Ks = _backward_sweep(A, Bu, grad_g, hess_g, mu)
    # the line-search forwards re-emit their visited states, so the accepted
    # candidate's trajectory carries straight into the next backward pass
    Js, xs_cand, us_cand = _line_search(prob, xs, us, kffs, Ks, alphas)
    batch = torch.arange(J.shape[0], device=J.device)
    best = torch.argmin(Js, dim=0)
    J_best = Js[best, batch]
    improved = J_best < J
    us = torch.where(improved[None, :, None], us_cand[best, :, batch].transpose(0, 1), us)
    xs = torch.where(improved[None, :, None], xs_cand[best, :, batch].transpose(0, 1), xs)
    J = torch.where(improved, J_best, J)
    # Levenberg schedule: relax toward Newton on success, back off toward
    # (scaled) gradient descent when every step is rejected
    mu = torch.where(improved, torch.clamp(mu / 3.0, min=1e-8), torch.clamp(mu * 10.0, max=1e8))
    return xs, us, J, mu


def ilqr_plan(
    env,
    state,
    actions,
    iterations: int = 10,
    *,
    mu: float = 1e-3,
    alphas: tuple = (1.0, 0.3, 0.1, 0.03, 0.01),
    action_cost: float = 1e-4,
    stage_cost: Callable = None,
) -> mpc.PlanResult:
    """Open-loop trajectory optimization by iterative LQR.

    Args:
        env: a batched :class:`~exciting_environments_torch.core.env.CoreEnvironment`,
            classic or PMSM.  The default cost needs ``control_state`` and a
            state with set references (``episodes.reset_with_references``).
        state: batched state to plan from (references frozen during the plan,
            like every planner here).
        actions: initial normalized plan ``(batch_size, horizon, action_dim)``.
        iterations: iLQR iterations (backward sweep + line-searched forward).
        mu: initial Levenberg regularization added to ``Quu`` in the backward
            pass; adapted per instance and iteration (÷3 on an accepted step,
            ×10 when the whole line search is rejected).
        alphas: parallel line-search step sizes; a candidate is only
            accepted if it improves the nominal cost, so iterates never
            regress regardless of the values given.
        action_cost: quadratic action-energy weight added to the default
            cost (keeps ``Quu`` positive-definite when the tracking reward
            ignores the action; set 0.0 for exact
            ``mpc._trajectory_cost`` parity).
        stage_cost: optional ``stage_cost(x_next_norm, u_norm, ref_norm,
            env_properties) -> cost`` replacing the default (applied at
            each post-step state; ``action_cost`` is then ignored).  Unlike
            the JAX package's per-instance callable it works elementwise
            over leading axes: ``(..., n)``, ``(..., m)`` and ``(...,
            n_refs)`` in, ``(...)`` out, the properties' ``(batch_size,)``
            leaves aligned with the last leading axis.

    Returns:
        :class:`~exciting_environments_torch.utils.mpc.PlanResult`: optimized
        actions ``(batch_size, horizon, action_dim)`` and the batch-mean
        cost curve ``(iterations + 1,)`` (entry 0 = initial plan).
    """
    if not hasattr(env, "_state_from_normalized_physical") or not hasattr(env, "_advance_state"):
        raise TypeError(
            "ilqr_plan needs a CoreEnvironment (state reconstruction and the "
            f"differentiable _advance_state transition); got {type(env).__name__}"
        )
    mpc._check_cost_setup(env, stage_cost, state)
    B, A = env.batch_size, env.action_dim
    if actions.ndim != 3 or actions.shape[0] != B or actions.shape[2] != A:
        raise ValueError(
            f"actions must have shape (batch_size, horizon, action_dim) = "
            f"({B}, horizon, {A}), but {tuple(actions.shape)} is given"
        )
    prob = _problem(env, state, action_cost, stage_cost)
    alphas_t = torch.as_tensor(alphas, dtype=env.dtype, device=env.device)
    with torch.no_grad():
        us = actions.detach().to(dtype=env.dtype, device=env.device).transpose(0, 1)  # (H, B, m)
        xs, J = _rollout_cost(prob, us)
        mu_k = torch.full((B,), float(mu), dtype=env.dtype, device=env.device)
        curve = []
        for _ in range(iterations):
            curve.append(J)
            xs, us, J, mu_k = _iteration(prob, xs, us, J, mu_k, alphas_t)
        curve.append(J)
    return mpc.PlanResult(actions=us.transpose(0, 1), costs=torch.mean(torch.stack(curve, dim=1), dim=0))
