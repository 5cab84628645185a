"""Carry states and properties across from the JAX package as numpy arrays.

The functions take plain numpy values (scalars or ``(B,)`` arrays), so a
caller holding JAX arrays converts them with ``np.asarray`` first; nothing
here imports JAX.
"""

from __future__ import annotations

import math
from dataclasses import fields

import numpy as np
import torch

from exciting_environments_torch.core.env import resolve_device
from exciting_environments_torch.utils import MinMaxNormalization


def state_from_numpy(env, arrays: dict, reference: dict = None, keys=None):
    """Build ``env``'s batched ``State`` from physical-state leaves.

    Args:
        env: a port environment.
        arrays: ``{field: (B,) array}`` for every physical-state field.
        reference: optional ``{field: (B,) array}`` tracking references
            (NaN where missing).
        keys: optional ``(B, 2)`` raw threefry keys (the JAX package's
            ``uint32`` key data) that the state carries.

    Returns:
        A ``State`` on ``env.device`` in ``env.dtype`` with the fresh-state
        solver carry (from the environment's own ``_init_solver_additions``,
        the PMSM's included) and ``keys`` as int64 key words, or the key
        placeholder of a key-less reset.
    """
    names = [f.name for f in fields(env.PhysicalState)]
    missing = set(names) - set(arrays)
    if missing:
        raise ValueError(f"missing physical-state leaves: {sorted(missing)}")
    to_t = lambda v: torch.as_tensor(np.array(v), dtype=env.dtype).to(env.device)
    phys = env.PhysicalState(**{n: to_t(arrays[n]) for n in names})
    batch_shape = tuple(phys.__dict__[names[0]].shape)
    ref = env._nan_reference(batch_shape)
    for name, value in (reference or {}).items():
        setattr(ref, name, to_t(value))
    return env.State(
        physical_state=phys,
        PRNGKey=(env._full(batch_shape, math.nan) if keys is None
                 else torch.as_tensor(np.asarray(keys).astype(np.int64)).to(env.device)),
        additions=env._init_solver_additions(env.env_properties, phys),
        reference=ref,
    )


def properties_from_numpy(env, static_params: dict, physical_normalizations: dict,
                          action_normalizations: dict, saturated: bool = None):
    """Build ``env``'s ``EnvProperties`` from numpy values.

    Normalizations are given as ``{field: (min, max)}``.  Scalars (Python or
    numpy, or 0-dim arrays) become Python floats, so they fold like Python
    numbers; ``(B,)`` arrays become tensors on ``env.device`` in ``env.dtype``.
    ``saturated`` is the PMSM's magnetics flag (default: the environment's
    own); environments without it take ``None``.
    """

    def norms(cls, d):
        return cls(**{k: MinMaxNormalization(min=lo, max=hi) for k, (lo, hi) in d.items()})

    extra = {}
    if "saturated" in {f.name for f in fields(env.EnvProperties)}:
        extra["saturated"] = bool(env.env_properties.saturated if saturated is None else saturated)
    elif saturated is not None:
        raise ValueError(f"{type(env).__name__} has no saturated flag")
    return env._place_properties(
        env.EnvProperties(
            physical_normalizations=norms(env.PhysicalState, physical_normalizations),
            action_normalizations=norms(env.Action, action_normalizations),
            static_params=env.StaticParams(**static_params),
            **extra,
        )
    )


def lut_values(env) -> np.ndarray:
    """The PMSM's stacked magnetics table ``(6, nx, ny)`` as numpy (the
    counterpart of ``np.asarray(jax_env._lut.values)``)."""
    if getattr(env, "_lut", None) is None:
        raise ValueError(f"{type(env).__name__} has no magnetics table")
    return env._lut.values.detach().cpu().numpy()


def actor_params_from_numpy(env, tree: dict) -> dict:
    """The JAX package's in-kernel actor parameters (``{"actor": [{"w", "b"},
    ...], "log_std", "seed"}`` of ``utils/rl_fused.py``, as numpy values) as
    the same structure of tensors on ``env.device`` in ``env.dtype``, for
    :class:`~exciting_environments_torch.utils.rl_fused.ActorPolicy`.
    ``seed`` stays a float-encoded integer, as in the JAX package."""
    to_t = lambda v: torch.as_tensor(np.array(v, dtype=np.float64), dtype=env.dtype).to(env.device)
    return {
        "actor": [{"w": to_t(layer["w"]), "b": to_t(layer["b"])} for layer in tree["actor"]],
        "log_std": to_t(tree["log_std"]),
        "seed": to_t(tree["seed"]),
    }


def actor_params_to_numpy(tree: dict) -> dict:
    """The inverse of :func:`actor_params_from_numpy`: the actor's tensors as
    float64 numpy arrays in the JAX package's structure, ``seed``
    included."""
    return {
        "actor": [{"w": _to_numpy(layer["w"]), "b": _to_numpy(layer["b"])} for layer in tree["actor"]],
        "log_std": _to_numpy(tree["log_std"]),
        "seed": _to_numpy(tree["seed"]),
    }


#: the top-level keys of the JAX package's agent trees: the PPO agent of
#: ``utils/rl.py`` and the fused agent of ``utils/rl_fused.py`` (the same
#: format, a smaller actor), and the SAC agent of ``utils/sac.py``
AGENT_KEYS = {
    "ppo": ("actor", "log_std", "critic"),
    "sac": ("actor", "q1", "q2", "q1_target", "q2_target", "log_alpha"),
}
_MLPS = {"ppo": ("actor", "critic"), "sac": ("actor", "q1", "q2", "q1_target", "q2_target")}


def agent_params_from_numpy(env, tree: dict) -> dict:
    """The JAX package's agent parameters (the trees of ``init_agent``,
    ``init_fused_agent`` and ``init_sac_agent`` and what their trainers
    return, as numpy values) as the same structure of tensors on
    ``env.device`` in ``env.dtype``, for ``utils/rl.py``,
    ``utils/rl_fused.py`` and ``utils/sac.py``.  Each MLP is a list of
    ``{"w": (m, n), "b": (n,)}`` layers (``x @ w + b``)."""
    kind = next((k for k, keys in AGENT_KEYS.items() if set(tree) == set(keys)), None)
    if kind is None:
        raise ValueError(f"an agent tree has the keys {AGENT_KEYS['ppo']} or {AGENT_KEYS['sac']}, got {sorted(tree)}")
    for name in _MLPS[kind]:
        for layer in tree[name]:
            w, b = np.shape(layer["w"]), np.shape(layer["b"])
            if set(layer) != {"w", "b"} or len(w) != 2 or b != (w[1],):
                raise ValueError(f"{name}: a layer is {{'w': (m, n), 'b': (n,)}}, got {sorted(layer)} {w} {b}")
    return tree_from_numpy(tree, env.dtype, env.device)


def _to_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().astype(np.float64)
    return np.asarray(value, dtype=np.float64)


def tree_from_numpy(tree, dtype=torch.float64, device=None):
    """A policy-parameter tree (dicts, lists and tuples of numpy values or
    scalars, such as gains trained by the JAX package) as the same structure
    of tensors in ``dtype`` on ``device``: the CUDA device unless the caller
    names another (``device="cpu"``), and a raise without a GPU, as every
    entry point of the port resolves it (``core/env.py::resolve_device``)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, dtype, device) for v in tree)
    return torch.as_tensor(np.array(tree, dtype=np.float64), dtype=dtype).to(device)


def tree_to_numpy(tree):
    """The inverse of :func:`tree_from_numpy` (and of
    :func:`agent_params_from_numpy`): every tensor of the tree as a float64
    numpy array, for the JAX package (``jnp.asarray`` on each)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    return _to_numpy(tree)


def scheduled_lut_from_numpy(env, values, carry_idx=(0, 1)):
    """The JAX package's ``ScheduledLUT`` maps (``np.asarray(sched.values)``,
    e.g. the gain schedule of its ``make_pmsm_saturated_sensorless_current_tile``)
    as the port's :class:`~exciting_environments_torch.ops.lut.ScheduledLUT`,
    checked against ``env``'s magnetics grid."""
    from exciting_environments_torch.ops.lut import ScheduledLUT

    if getattr(env, "_lut", None) is None:
        raise ValueError(f"{type(env).__name__} has no magnetics table to schedule on")
    values = np.asarray(values, dtype=np.float64)
    if values.ndim != 3 or values.shape[1:] != (env._lut.nx, env._lut.ny):
        raise ValueError(f"scheduled maps {values.shape} must be (C, {env._lut.nx}, {env._lut.ny})")
    return ScheduledLUT(values, carry_idx)
