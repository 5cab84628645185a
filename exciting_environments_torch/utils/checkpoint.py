"""Checkpoint / resume of simulation state (counterpart of
``exciting_environments_tpu/utils/checkpoint.py``).

* :func:`save_state` / :func:`load_state` — persist any state container
  (an environment ``State``, a trajectory's states, tuples, lists and dicts
  of tensors) in the JAX package's dependency-free ``.npz`` layout: ``n``
  (the leaf count), ``leaf_{i}`` (each leaf as a numpy array) and
  ``path_{i}`` (each leaf's key path, the string ``jax.tree_util.keystr``
  gives for the same state in the JAX package).  A state saved by either
  package loads in the other.
* :func:`save_sim_properties` / :func:`load_sim_properties` — re-exports of
  the JSON round-trip of :mod:`exciting_environments_torch.utils`.

Keys of :mod:`~exciting_environments_torch.ops.random` (int64 ``(..., 2)``
leaves named ``PRNGKey`` holding two uint32 words) are stored as ``uint32``,
the raw JAX key; loading turns them back into int64 words.  A Python-scalar
leaf (a fresh state's ``active_solver_state=False``) is stored broadcast
over the batch shape, the shape of the container's first tensor leaf, as the
JAX package's vmapped state holds it, and loads as a tensor.  Restored leaves
are checked against the ``like`` template's key paths, shapes and dtypes
with the JAX package's messages, and land on the template's devices.

The port has no orbax backend: ``ORBAX_AVAILABLE`` is ``False`` and
``use_orbax=True`` raises.  ``torch.save`` is not used, since the JAX
package could not read its files.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.utils import (
    dump_sim_properties_to_json as save_sim_properties,
    load_sim_properties_from_json as load_sim_properties,
)

ORBAX_AVAILABLE = False

__all__ = [
    "save_state",
    "load_state",
    "save_sim_properties",
    "load_sim_properties",
    "ORBAX_AVAILABLE",
]

_KEY_FIELD = "['PRNGKey']"


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _refuse_orbax(use_orbax):
    if use_orbax:
        raise ValueError(
            "use_orbax=True: the PyTorch port has no orbax backend (ORBAX_AVAILABLE is False); "
            "checkpoints use the .npz layout, which the JAX package reads with use_orbax=False"
        )


def leaves_with_path(tree, prefix: str = ""):
    """``[(path, leaf), ...]`` of a state container in the JAX package's
    leaf order, each path the string ``jax.tree_util.keystr`` gives for the
    same pytree there: ``['field']`` for a dataclass field and a dict key
    (dict keys sorted), ``.field`` for a named tuple, ``[i]`` for a tuple
    or list entry.  ``None`` is an empty subtree."""
    if tree is None:
        return []
    if structures.is_dataclass(tree):
        return [item for f in dataclasses.fields(tree)
                for item in leaves_with_path(getattr(tree, f.name), f"{prefix}[{f.name!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for name in tree._fields for item in leaves_with_path(getattr(tree, name), f"{prefix}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree) for item in leaves_with_path(v, f"{prefix}[{i}]")]
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in leaves_with_path(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def _unflatten(tree, values):
    """``tree`` with its leaves (in :func:`leaves_with_path` order) replaced
    by ``values``."""
    it = iter(values)

    def go(node):
        if node is None:
            return None
        if structures.is_dataclass(node):
            new = object.__new__(type(node))
            for f in dataclasses.fields(node):
                object.__setattr__(new, f.name, go(getattr(node, f.name)))
            return new
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(go(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(go(v) for v in node)
        if isinstance(node, dict):
            out = {k: go(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        return next(it)

    return go(tree)


def _is_key(path: str, leaf) -> bool:
    return (path.endswith(_KEY_FIELD) and isinstance(leaf, torch.Tensor) and leaf.dtype == torch.int64
            and leaf.shape[-1:] == (2,))


def _batch_shape(items) -> tuple:
    """The shape a Python-scalar leaf is stored with: that of the
    container's first tensor leaf (a state's batch shape)."""
    return next((tuple(leaf.shape) for _, leaf in items if isinstance(leaf, torch.Tensor)), ())


def _stored(path: str, leaf, batch_shape: tuple) -> np.ndarray:
    """The numpy array a leaf is saved as: a key as its uint32 words, a
    Python scalar (a fresh state's ``active_solver_state=False``) broadcast
    over the batch shape, as the JAX package's vmapped state holds it."""
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy()
        return arr.astype(np.uint32) if _is_key(path, leaf) else arr
    return np.full(batch_shape, leaf)


def _restored(arr: np.ndarray, like, device):
    """A stored array as a leaf like ``like``: a tensor of its dtype on its
    device (a Python-scalar template leaf: a tensor on ``device``, the
    template's first tensor leaf's)."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(dtype=like.dtype, device=like.device)
    return torch.from_numpy(np.array(arr)).to(device=device)


def save_state(state, path: str, use_orbax: bool = None):
    """Persist a state container to ``path`` (``.npz`` appended when
    missing); returns the file's path.

    Args:
        state: any container of tensors (environment ``State``, trajectory
            ``states``, ...).
        path: target ``.npz`` file.
        use_orbax: ``None`` or ``False``; ``True`` raises (no orbax here).
    """
    _refuse_orbax(use_orbax)
    items = leaves_with_path(state)
    batch_shape = _batch_shape(items)
    arrays = {}
    for i, (keypath, leaf) in enumerate(items):
        arrays[f"leaf_{i}"] = _stored(keypath, leaf, batch_shape)
        arrays[f"path_{i}"] = np.array(keypath)
    np.savez(_npz_path(path), n=np.array(len(items)), **arrays)
    return _npz_path(path)


def load_state(like, path: str, use_orbax: bool = None):
    """Restore a state container from ``path``.

    Args:
        like: a container with the target structure (e.g. from
            ``env.vmap_init_state()``); restored leaves are checked against
            its key paths, shapes and dtypes and placed on its devices.
        path: ``.npz`` file.
        use_orbax: ``None`` or ``False``; ``True`` raises (no orbax here).
    """
    _refuse_orbax(use_orbax)
    data = np.load(_npz_path(path), allow_pickle=False)
    n = int(data["n"])
    expected = leaves_with_path(like)
    if n != len(expected):
        raise ValueError(f"checkpoint has {n} leaves, target structure has {len(expected)}")
    batch_shape = _batch_shape(expected)
    device = next((leaf.device for _, leaf in expected if isinstance(leaf, torch.Tensor)), None)
    leaves = []
    for i, (expected_path, like_leaf) in enumerate(expected):
        stored_path = str(data[f"path_{i}"])
        if stored_path != expected_path:
            raise ValueError(
                f"leaf {i} path mismatch: checkpoint {stored_path!r} vs target {expected_path!r}"
            )
        leaf = data[f"leaf_{i}"]
        # catch batch-size/dtype mismatches at load time instead of as an
        # opaque shape error later
        like_arr = _stored(expected_path, like_leaf, batch_shape)
        shape, dtype = like_arr.shape, like_arr.dtype
        if leaf.shape != shape:
            raise ValueError(
                f"leaf {stored_path!r} shape mismatch: checkpoint {leaf.shape} vs target {shape}"
            )
        if leaf.dtype != dtype:
            raise ValueError(
                f"leaf {stored_path!r} dtype mismatch: checkpoint {leaf.dtype} vs target {dtype}"
            )
        leaves.append(_restored(leaf, like_leaf, device))
    return _unflatten(like, leaves)
