"""What the drivers' comparisons share: gaps on a circle, the largest gap,
and the reference's outputs of several calls cut apart."""

from __future__ import annotations

import torch


def split(outputs, n: int) -> list:
    """Outputs of ``n`` cases stacked along the batch, as one tuple per
    case (nested tuples kept)."""
    def cut(x):
        return [tuple(p) for p in zip(*(cut(y) for y in x))] if isinstance(x, tuple) else list(x.chunk(n))
    return cut(tuple(outputs))


def wrapped_gap(a, b, period: float):
    """``|a - b|`` on a circle of ``period``."""
    d = torch.remainder(a.double() - b.double() + period / 2, period) - period / 2
    return d.abs()


def max_gap(*gaps) -> float:
    """The largest of tensors of gaps (NaN where any is NaN)."""
    return float(torch.stack([g.double().max() for g in gaps]).max())
