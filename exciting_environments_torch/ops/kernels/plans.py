"""Launch plans of the closed-loop wrappers: the checked and packed static
part of one launch's arguments, kept per call site and reused while its
inputs stay the same.

A fleet loop calls ``kernel_closed_loop`` or ``kernel_pmsm_closed_loop``
with the same environment, properties, solver and policy every chunk; only
the state, carry and output pointers change.  A :class:`LaunchPlan` keeps
the wrapper's ctypes struct with every static field filled, after every
check passed.  A :class:`PlanCache` finds it by a key of what those fields
and checks read:

* objects (the environment, its properties, the solver, the policy, the
  tables) by identity.  The plan holds them weakly, so it keeps nothing
  alive, and a key whose objects all still live names no other object;
* tensors by identity, ``_version`` and data pointer, so an in-place write
  misses;
* Python numbers by value.

A hit launches through :meth:`PlanCache.launch`; a miss runs the wrapper's
full path, which builds the plan again (:meth:`PlanCache.missed`).  The
entry points' scope checks are kept the same way (:meth:`PlanCache.in_scope`).
"""

from __future__ import annotations

import numbers
import weakref

import torch

_PLAIN = (numbers.Number, str, type(None))
#: the types of most leaves, told apart without an abstract-class check
_EXACT = frozenset((float, int, bool, str, type(None)))
#: plans kept a wrapper, and keys of environments whose scope check passed
_PLANS_KEPT = 4


class Key:
    """A plan key in the making: :attr:`tokens` (compared as a tuple) and
    :attr:`live`, the objects named by identity.  :attr:`cacheable` turns
    false where an input can be named by neither."""

    __slots__ = ("tokens", "live", "cacheable")

    def __init__(self):
        self.tokens, self.live, self.cacheable = [], [], True

    def obj(self, obj):
        """``obj`` by identity (``None`` by value)."""
        if obj is None:
            self.tokens.append(None)
        else:
            self.tokens.append(id(obj))
            self.live.append(obj)

    def leaf(self, leaf):
        """A tensor by identity, version and data pointer, a Python number by
        value; anything else (an array, a list) makes the key uncacheable."""
        if type(leaf) in _EXACT:
            self.tokens.append(leaf)
        elif isinstance(leaf, torch.Tensor):
            self.tokens += (id(leaf), leaf._version, leaf.data_ptr())
            self.live.append(leaf)
        elif isinstance(leaf, _PLAIN):
            self.tokens.append(leaf)
        else:
            self.cacheable = False

    def tree(self, tree):
        """Every leaf of a properties tree (nested dataclasses of tensors and
        numbers) in field order, as :meth:`leaf` names it (inlined: a launch
        walks the tree)."""
        tokens = self.tokens
        for leaf in vars(tree).values():
            kind = type(leaf)
            if kind in _EXACT:
                tokens.append(leaf)
            elif hasattr(kind, "__dataclass_fields__"):
                self.tree(leaf)
            elif isinstance(leaf, torch.Tensor):
                tokens += (id(leaf), leaf._version, leaf.data_ptr())
                self.live.append(leaf)
            else:
                self.leaf(leaf)

    def values(self, *values):
        self.tokens += values

    def env(self, env, props, solver):
        """What the wrappers and the entry points' scope checks read of an
        environment: the environment, its properties (every leaf), the solver,
        the batch size, the tracked references and the attributes a user may
        set after construction (the table, the fast-math flag, the action
        hook)."""
        self.obj(env)
        self.obj(props)
        self.tree(props)
        self.obj(solver)
        self.obj(getattr(env, "_lut", None))
        self.obj(getattr(env, "_constrain_action_tuple", None))
        self.values(env.batch_size, len(env.control_state), getattr(env, "fast_math", False))
        return self

    def weak(self):
        """Weak references to :attr:`live`, or ``None`` where one of them
        takes none (the key then names nothing it can confirm)."""
        try:
            return tuple(weakref.ref(o) for o in self.live)
        except TypeError:
            return None


def _alive(refs) -> bool:
    return all(ref() is not None for ref in refs)


class LaunchPlan:
    """One launch's static part: ``args`` (the wrapper's struct with every
    static field filled and no per-chunk pointer), ``packs`` (the policy's
    ``spec_packs`` when it was built: a policy that packed no spec since
    hands out the plan's spec again), ``grads`` (weak references to the
    static tensors autograd could record), ``hold`` (tensors the static
    fields point at that the plan keeps: tables, none of them batch-sized)
    and the wrapper's own ``extra``."""

    __slots__ = ("tokens", "refs", "args", "packs", "grads", "hold", "extra")

    def __init__(self, tokens, refs, args, packs, grads, hold, extra):
        self.tokens, self.refs, self.args, self.packs = tokens, refs, args, packs
        self.grads, self.hold, self.extra = grads, hold, extra

    def current(self, policy) -> bool:
        """Whether ``policy`` packed no spec since the plan was built: the
        spec it handed out for this launch is the plan's."""
        return policy.spec_packs == self.packs

    def records_grad(self, leaves) -> bool:
        """The wrapper's autograd test over the per-chunk ``leaves`` and the
        plan's static tensors."""
        return torch.is_grad_enabled() and (any(t.requires_grad for t in leaves)
                                            or any(ref().requires_grad for ref in self.grads))


class Pointers:
    """The pointers a launch reads: ``ptr(t)`` gives the data pointer of ``t``
    made contiguous and keeps that tensor alive until the launch.
    :attr:`copied` turns true where a leaf had to be copied (a plan cannot
    keep the copy's pointer)."""

    __slots__ = ("keep", "copied")

    def __init__(self):
        self.keep, self.copied = [], False

    def __call__(self, t) -> int:
        c = t.contiguous()
        self.copied = self.copied or c is not t
        self.keep.append(c)
        return c.data_ptr()


class PlanCache:
    """At most :data:`_PLANS_KEPT` plans of one wrapper, the newest first, and
    as many keys of environments whose scope check passed.  ``counts`` is the
    wrapper's ``{"hits", "misses"}``: a launch through a kept plan, a launch
    through the full path."""

    def __init__(self, counts: dict):
        self.counts = counts
        self._plans, self._scoped = [], []

    def __len__(self):
        return len(self._plans)

    def clear(self):
        self._plans.clear()
        self._scoped.clear()

    def find(self, key: Key):
        """The kept plan of ``key``, or ``None``."""
        tokens = tuple(key.tokens)
        for plan in self._plans:
            if plan.tokens == tokens and _alive(plan.refs):
                return plan
        return None

    def launch(self, key, leaves, slabs, policy, spec_fn, struct, chunk_fn, launch_fn):
        """Launch through the kept plan of ``key`` (``None``: no plan).

        ``leaves`` are the per-chunk ``(batch,)`` tensors, the first giving the
        dtype, device and batch; ``slabs`` are ``(tensor or None, shape)``
        pairs.  Where all fit (:func:`fits`), ``spec_fn()`` takes the policy's
        spec; where ``policy`` packed no spec since the plan was built and
        autograd records nothing, a copy of the plan's ``struct`` gets the
        per-chunk pointers from ``chunk_fn(args)`` (which returns the outputs
        and the tensors the launch reads) and ``launch_fn(args, plan.extra)``
        launches it.  Returns ``(outputs, spec)``: ``outputs`` ``None`` where
        the full path has to run, ``spec`` the spec taken (or ``None``), which
        the full path takes over, so a launch takes one spec."""
        plan = None if key is None else self.find(key)
        if plan is None:
            return None, None
        first = leaves[0]
        dtype, device = first.dtype, first.device
        if not (fits(leaves, dtype, device, (first.shape[0],))
                and all(t is None or fits((t,), dtype, device, shape) for t, shape in slabs)):
            return None, None
        spec = spec_fn()
        grads = (*leaves, *(t for t, _ in slabs if t is not None), spec.flat)
        if not plan.current(policy) or plan.records_grad(grads):
            return None, spec
        args = struct.from_buffer_copy(plan.args)
        outputs, keep = chunk_fn(args)  # ``keep`` lives until the launch is queued
        launch_fn(args, plan.extra)
        self.counts["hits"] += 1
        return outputs, spec

    def keep(self, key: Key, args, policy, grads=(), hold=(), extra=None) -> bool:
        """Keep the plan of a launch built by the full path, in place of one
        of the same key, the oldest beyond :data:`_PLANS_KEPT` dropped.
        Nothing is kept where the key cannot be confirmed or ``policy`` packs
        a new spec every launch (``spec_packs`` is ``None``)."""
        refs = key.weak() if key.cacheable and policy.spec_packs is not None else None
        if refs is None:
            return False
        tokens = tuple(key.tokens)
        plan = LaunchPlan(tokens, refs, args, policy.spec_packs, tuple(weakref.ref(t) for t in grads), tuple(hold),
                          extra)
        self._plans = [plan] + [p for p in self._plans if p.tokens != tokens and _alive(p.refs)][: _PLANS_KEPT - 1]
        return True

    def missed(self, key, args, policy, pointers: Pointers, grads=(), hold=(), extra=None) -> bool:
        """Count a launch through the full path and keep its plan (``args``,
        the struct with its static fields only), where it has a ``key`` and
        no static leaf was copied (:class:`Pointers`)."""
        self.counts["misses"] += 1
        if key is None or pointers.copied:
            return False
        return self.keep(key, args, policy, grads=grads, hold=hold, extra=extra)

    def in_scope(self, key: Key, check) -> bool:
        """``check()``, or ``True`` without calling it where it passed for the
        same key before."""
        tokens = tuple(key.tokens)
        if any(t == tokens and _alive(refs) for t, refs in self._scoped):
            return True
        if not check():
            return False
        refs = key.weak()
        if key.cacheable and refs is not None:
            self._scoped = [(tokens, refs)] + [e for e in self._scoped if e[0] != tokens and _alive(e[1])][
                : _PLANS_KEPT - 1]
        return True


def fits(leaves, dtype, device, shape) -> bool:
    """Whether every tensor of ``leaves`` has ``dtype``, ``device`` and
    ``shape`` and is contiguous: what a plan's launch takes of its per-chunk
    leaves (the full path checks, or copies, anything else)."""
    index = -1 if device.index is None else device.index  # ``get_device`` makes no device object
    return all(isinstance(t, torch.Tensor) and t.dtype is dtype and t.get_device() == index and t.shape == shape
               and t.is_contiguous() for t in leaves)
