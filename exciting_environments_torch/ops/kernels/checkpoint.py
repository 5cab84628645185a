"""The pieces shared by the exact kernels' backward passes.

The JAX package differentiates its four exact Pallas kernels through
``custom_vjp``s (``ops/pallas/stepper.py::_fused_core_bwd`` and
``_cl_core_bwd``, ``ops/pallas/pmsm_stepper.py::_pmsm_core_diff_bwd`` and
``_pmsm_cl_core_bwd``).  None of the four is a kernel: each replays the
kernel's plain per-step function under ``jax.vjp``, segment by segment, from
checkpoints that the forward kernel saved.  The port does the same with a
``torch.autograd.Function`` per kernel: its forward launches the CUDA kernel
with saves every :func:`ckpt_stride` steps (on CPU tensors the plain loop,
with the same saves and no graph), and its backward walks the segments in
reverse, replays each one through the plain step under autograd
(:func:`segment_vjp`) and carries the state's and the carry's cotangents
across segment boundaries.  Only one segment's graph is alive at a time.
One backward is a kernel instead: ``PmsmClosedLoopVJP``'s, where the forward
ran on CUDA with 1-step segments under the affine law, explicit Euler and no
noise or schedule, launches ``csrc/pmsm_closed_loop_adjoint.cu``
(``ops/kernels/pmsm_closed_loop_adjoint.py``) and replays nothing.
"""

from __future__ import annotations

import torch


class VJPConfig:
    """The non-tensor arguments of a VJP ``Function`` and the layout of its
    tensor inputs: group sizes, in order (``split``)."""

    def __init__(self, sizes, **fields):
        self.sizes = tuple(sizes)
        self.n_in = sum(self.sizes)
        self.__dict__.update(fields)

    def split(self, tensors):
        out, k = [], 0
        for n in self.sizes:
            out.append(tuple(tensors[k : k + n]))
            k += n
        return out


def ckpt_stride(n_steps: int, traj_stride) -> int:
    """Checkpoint interval of the backward sweep: the divisor ``d`` of
    ``traj_stride`` (or of ``n_steps`` without one) that minimizes
    ``n_steps / d + d``, the checkpoint saves plus one segment's replay,
    with ties going to the smaller divisor.  A divisor of the save stride
    makes the user's saves a slice of the checkpoints; ``traj_stride=1``
    (``obs_stride=1``, as ``train_policy`` asks) gives 1-step segments, a
    checkpoint every step, which the PMSM closed loop's adjoint kernel reads."""
    base = traj_stride if traj_stride is not None else n_steps
    divisors = set()
    for d in range(1, int(base ** 0.5) + 1):
        if base % d == 0:
            divisors.update((d, base // d))
    return min(divisors, key=lambda d: (n_steps / d + d, d))


def tensors(*nests):
    """Every tensor in ``nests``, in order: a nest is a tensor, a dataclass
    (its fields, in field order), a dict, list or tuple of nests, or a
    module (its parameters and buffers); anything else holds none."""
    out, stack = [], list(reversed(nests))
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, torch.nn.Module):
            out.extend(node.parameters())
            out.extend(node.buffers())
        elif hasattr(node, "__dataclass_fields__"):
            stack.extend(reversed(node.__dict__.values()))
        elif isinstance(node, dict):
            stack.extend(reversed(node.values()))
        elif isinstance(node, (list, tuple)):
            stack.extend(reversed(node))
    return out


def records_grad(*nests) -> bool:
    """Whether autograd records a call on the inputs ``nests``: grad mode is
    on and one of their tensors (:func:`tensors`) requires grad.  On CPU
    tensors each entry point enters its VJP ``Function`` only then; on CUDA
    tensors each kernel wrapper asks the same of the tensors it reads."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors(*nests))


def starts(leaves0, saves):
    """Segment start leaves ``(n_seg, B)``: the initial leaf, then every
    checkpoint save but the last (each save ``(n_seg, B)``, time-major)."""
    return tuple(torch.cat([leaf0[None], save[:-1]]) for leaf0, save in zip(leaves0, saves))


def inject(g_traj, skip: int, n_seg: int):
    """The trajectory cotangents ``(n_saves, B)`` scattered onto the segment
    ends ``(n_seg, B)``: save ``k`` is the end of segment ``(k + 1) * skip -
    1``, and segments without a save get zeros.  ``None`` entries (outputs
    without a cotangent) stay ``None``."""
    out = []
    for g in g_traj:
        if g is None:
            out.append(None)
            continue
        seg = g.new_zeros((n_seg,) + tuple(g.shape[1:]))
        seg[skip - 1 :: skip] = g
        out.append(seg)
    return tuple(out)


def add(acc, g):
    """``acc + g`` with ``None`` as zero."""
    if g is None:
        return acc
    return g if acc is None else acc + g


def segment_vjp(fn, inputs, needs, seeds=()):
    """Replay one segment under autograd and pull its output cotangents back.

    Args:
        fn: ``fn(*leaves) -> [(output, cotangent), ...]``, the segment's
            replay over detached copies of ``inputs``; pairs whose cotangent
            is ``None`` are left out.
        inputs: the tensors (or ``None``) the replay reads.
        needs: per input, whether its cotangent is wanted.
        seeds: ``(input index, cotangent)`` pairs that enter an input's
            cotangent before the replay's own contributions: the saves at
            the segment's start, added in the order in which autograd
            through the whole loop adds them (first), so that the sums
            round alike.

    Returns:
        The cotangent of each input (``None`` where not wanted, or where no
        output depends on it).
    """
    leaves = [None if x is None else x.detach().requires_grad_(bool(n)) for x, n in zip(inputs, needs)]
    with torch.enable_grad():
        pairs = [(o, g) for o, g in fn(*leaves) if g is not None and o.requires_grad]
        # made last, so autograd runs these identities first
        pairs += [(leaves[i].view_as(leaves[i]), g) for i, g in seeds
                  if g is not None and leaves[i] is not None and leaves[i].requires_grad]
    wanted = [i for i, leaf in enumerate(leaves) if leaf is not None and leaf.requires_grad]
    grads = [None] * len(inputs)
    if not pairs or not wanted:
        return grads
    outs, cots = zip(*pairs)
    got = torch.autograd.grad(outs, [leaves[i] for i in wanted], cots, allow_unused=True)
    for i, g in zip(wanted, got):
        grads[i] = g
    return grads


def prop_tensors(props):
    """The floating-point tensor leaves of an ``EnvProperties`` (per-batch
    parameters and bands), in the leaf order of ``structures.leaves``."""
    return [t for t in tensors(props) if t.is_floating_point()]


def props_with(props, leaves):
    """``props`` with its floating-point tensor leaves replaced by
    ``leaves``, in the order of :func:`prop_tensors`."""
    from exciting_environments_torch.core import structures

    it = iter(leaves)
    return structures.map_leaves(
        lambda leaf: next(it) if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() else leaf, props)


def tree_with(tree, leaves):
    """A nest of dicts, lists and tuples with its tensors replaced by
    ``leaves``, in the order of :func:`tensors`."""
    it = iter(leaves)

    def go(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        return node

    return go(tree)
