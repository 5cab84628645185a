"""Gradient-based controller training through the closed-loop kernels
(counterpart of ``exciting_environments_tpu/utils/train.py``).

The closed loops are differentiable in their policy parameters: on CUDA
tensors the forward is one launch of the closed-loop kernel with a save
every step (``obs_stride=1``).  The backward of a PMSM drive under
``AffinePolicy`` (no clip) with explicit Euler and no noise is one launch of
the hand-written adjoint ``csrc/pmsm_closed_loop_adjoint.cu``; every other
backward, and every one on CPU tensors, is a replay of the kernel's plain
step under autograd, one step a segment
(``ops/kernels/closed_loop.py::ClosedLoopVJP``,
``ops/kernels/pmsm_closed_loop.py::PmsmClosedLoopVJP``; ``BACKWARD_PATHS``
counts the PMSM's).  That turns controller tuning into plain gradient
descent with the forward pass, and for the PMSM's PI and P laws the
backward too, at kernel speed.  :func:`train_policy` picks the kernel, runs the descent and
keeps the best iterate.

On CUDA tensors the policy is one of the families compiled into the kernel
(``AffinePolicy``, with or without ``Ki``; the deterministic actor of
``make_actor_tile`` on classic environments), and any other callable raises
before a launch; on CPU tensors any callable with the tile contract trains.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from exciting_environments_torch.ops.kernels.checkpoint import tensors, tree_with

__all__ = ["TrainResult", "default_tracking_loss", "train_policy"]


class TrainResult(NamedTuple):
    """Outcome of :func:`train_policy`.

    ``params``: the trained parameter tree (detached tensors).  ``losses``:
    the loss of each iteration at its pre-update parameters, a float64 CPU
    tensor of shape ``(iterations,)``.  ``final_loss``: the loss of the
    returned parameters.
    """

    params: object
    losses: torch.Tensor
    final_loss: float


def default_tracking_loss(env):
    """Mean squared normalized tracking error over the rollout.

    Pairs each tracked ``control_state`` component with its reference column
    in the observation layout (``env.obs_description``: the physical columns
    first, the references appended in ``control_state`` order, as both
    closed-loop kernels build the observation)."""
    names = list(env.obs_description)
    pairs = []
    for i, name in enumerate(env.control_state):
        ref_col = len(names) - len(env.control_state) + i
        if name not in names:
            raise ValueError(
                f"control_state component {name!r} not found in obs_description {names}; pass an explicit loss_fn"
            )
        pairs.append((names.index(name), ref_col))
    if not pairs:
        raise ValueError("default_tracking_loss needs a non-empty control_state; pass an explicit loss_fn instead")

    def loss(obs, acts):
        return sum(torch.mean((obs[:, :, a] - obs[:, :, b]) ** 2) for a, b in pairs)

    return loss


def _adam(parameters):
    return torch.optim.Adam(parameters, lr=0.1)


def train_policy(env, policy, params, state, n_steps: int, iterations: int, optimizer: Callable = None,
                 loss_fn: Callable = None, policy_carry=None) -> TrainResult:
    """Train ``policy(obs, t[, carry], params)`` by backprop through the
    closed loop.

    Args:
        env: a classic environment or a PMSM drive inside closed-loop kernel
            scope (:func:`~exciting_environments_torch.ops.kernels.closed_loop_path`),
            or a :class:`~exciting_environments_torch.parallel.mesh.ShardedEnv`
            over one (one launch per shard).
        policy: a tile-contract policy; on CUDA a compiled family
            (``AffinePolicy`` flat gains, with or without ``Ki``, or a
            deterministic ``ActorPolicy``'s weights).
        params: the initial parameter tree (a tensor, or dicts, lists and
            tuples of tensors) that ``policy`` takes as ``policy_params``;
            it is copied, never updated in place.
        state: the batched initial state (references set where tracked).
        n_steps: rollout length per iteration.
        iterations: optimizer steps.
        optimizer: a factory ``optimizer(list_of_tensors) ->
            torch.optim.Optimizer``; defaults to ``Adam(lr=0.1)``, the JAX
            package's ``optax.adam(0.1)``.
        loss_fn: ``loss(obs_traj, acts_traj) -> scalar`` over the ``(B,
            n_steps, obs_dim)`` observations and ``(B, n_steps, A)``
            normalized actions; defaults to :func:`default_tracking_loss`.
        policy_carry: the stateful policy's initial carry, the start of
            every rollout.

    Returns:
        :class:`TrainResult`.  Each loss belongs to the parameters before
        that iteration's update, and the best of them is returned when it
        beats the final loss (drive landscapes oscillate under Adam).
        Raises out of closed-loop kernel scope: there is no scan fallback.
    """
    from exciting_environments_torch.ops.kernels import closed_loop_path
    from exciting_environments_torch.ops.kernels.closed_loop import _PLAIN_CALLABLE_ON_CUDA
    from exciting_environments_torch.ops.policies import KernelPolicy

    if closed_loop_path(env) is None:
        raise ValueError(
            "train_policy requires closed-loop kernel scope (explicit RK solver with a kernel stage count, "
            "scalar normalizations for classic environments, at most 4 tracked references)"
        )
    if torch.device(env.device).type == "cuda" and not isinstance(policy, KernelPolicy):
        raise ValueError(_PLAIN_CALLABLE_ON_CUDA)
    if loss_fn is None:
        loss_fn = default_tracking_loss(env)
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors(params)]
    tree = tree_with(params, leaves)
    opt = (optimizer or _adam)(leaves)

    def loss(p):
        # one launch of the closed-loop kernel, or one per shard of a batch
        # split (the parameters' gradients sum over the shards)
        out = env.fused_closed_loop(state, policy, n_steps, obs_stride=1, policy_params=p, policy_carry=policy_carry)
        return loss_fn(out[0], out[1])

    losses = []
    best, best_loss = None, float("inf")
    for _ in range(iterations):
        opt.zero_grad()
        value = loss(tree)
        value.backward()
        v = float(value.detach())
        losses.append(v)
        if v < best_loss:
            best, best_loss = [t.detach().clone() for t in leaves], v
        opt.step()
    with torch.no_grad():
        final_loss = float(loss(tree))
    out = [t.detach().clone() for t in leaves]
    if best is not None and best_loss < final_loss:
        out, final_loss = best, best_loss
    return TrainResult(params=tree_with(params, out), losses=torch.tensor(losses, dtype=torch.float64),
                       final_loss=final_loss)
