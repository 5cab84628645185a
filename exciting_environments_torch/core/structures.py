"""Dataclass containers for environment state and properties (counterpart of
``exciting_environments_tpu/core/structures.py``).

Where the JAX package registers its dataclasses as pytrees, the port keeps
plain dataclasses whose leaves are tensors (or Python scalars).  The calling
conventions stay the same:

* :func:`dataclass` — class decorator producing a mutable dataclass;
* :func:`copy_and_mutate` — context manager yielding a container-level copy
  that may be mutated field by field without aliasing the source;
* :func:`replace` — functional field replacement;
* :func:`is_dataclass`, :func:`fields`, :func:`leaves`.

Tensor leaves are shared between a copy and its source, exactly as JAX
arrays are: the port never updates a leaf in place.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager


def dataclass(cls=None, **kwargs):
    """Decorate ``cls`` as a mutable dataclass with identity equality."""

    def wrap(c):
        return dataclasses.dataclass(eq=False, **kwargs)(c)

    if cls is None:
        return wrap
    return wrap(cls)


def is_dataclass(obj) -> bool:
    """True for dataclass *instances*."""
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def _copy_tree(obj):
    """Recursively copy dataclass nodes and list/dict/tuple containers;
    leaves are shared."""
    if is_dataclass(obj):
        new = object.__new__(type(obj))
        for f in dataclasses.fields(obj):
            object.__setattr__(new, f.name, _copy_tree(getattr(obj, f.name)))
        return new
    if isinstance(obj, tuple):
        return tuple(_copy_tree(v) for v in obj)
    if isinstance(obj, list):
        return [_copy_tree(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _copy_tree(v) for k, v in obj.items()}
    return obj


@contextmanager
def copy_and_mutate(obj, validate: bool = True):
    """Yield a container-level copy of ``obj`` for field mutation.
    ``validate`` is accepted for signature compatibility and ignored."""
    del validate
    yield _copy_tree(obj)


def replace(obj, **changes):
    """Functional field replacement."""
    new = _copy_tree(obj)
    for name, value in changes.items():
        if not hasattr(new, name):
            raise AttributeError(f"{type(obj).__name__} has no field {name!r}")
        object.__setattr__(new, name, value)
    return new


def fields(obj):
    """Re-export of :func:`dataclasses.fields`."""
    return dataclasses.fields(obj)


def leaves(obj):
    """Flatten dataclasses and tuples/lists into their leaves, in field order
    (``None`` is an empty subtree, as in JAX)."""
    if obj is None:
        return []
    if is_dataclass(obj):
        return [leaf for f in dataclasses.fields(obj) for leaf in leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [leaf for v in obj for leaf in leaves(v)]
    return [obj]


def map_leaves(fn, obj):
    """Apply ``fn`` to every leaf, keeping the container structure."""
    if obj is None:
        return None
    if is_dataclass(obj):
        new = object.__new__(type(obj))
        for f in dataclasses.fields(obj):
            object.__setattr__(new, f.name, map_leaves(fn, getattr(obj, f.name)))
        return new
    if isinstance(obj, tuple):
        return tuple(map_leaves(fn, v) for v in obj)
    if isinstance(obj, list):
        return [map_leaves(fn, v) for v in obj]
    return fn(obj)


def structure(obj):
    """Structural signature (container types and field names, no leaves) —
    the counterpart of comparing JAX tree structures."""
    if obj is None:
        return None
    if is_dataclass(obj):
        return (type(obj).__qualname__,) + tuple(
            (f.name, structure(getattr(obj, f.name))) for f in dataclasses.fields(obj)
        )
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(structure(v) for v in obj)
    return "*"


def unflatten(template, flat):
    """The inverse of :func:`leaves`: ``template``'s structure with its
    leaves taken in order from ``flat`` (the counterpart of
    ``jax.tree_util.tree_unflatten``)."""
    it = iter(flat)

    def build(node):
        if node is None:
            return None
        if is_dataclass(node):
            new = object.__new__(type(node))
            for f in dataclasses.fields(node):
                object.__setattr__(new, f.name, build(getattr(node, f.name)))
            return new
        if isinstance(node, tuple):
            return tuple(build(v) for v in node)
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out
