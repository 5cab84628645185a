"""Plain reference of a fleet loop's running observation statistics: the
count, mean, sum of squared deviations (M2), minimum and maximum per
observation channel, with a batch of observations folded in by the exact
pairwise merge of Chan, Golub and LeVeque (1979)."""

from __future__ import annotations

import torch


def fold(count, mean, m2, lo, hi, values):
    """The statistics ``(count, mean, m2, min, max)`` (per channel) after
    folding in ``values`` ``(N, C)``; all in the dtype of ``values``."""
    n_b = values.shape[0]
    mean_b = values.mean(dim=0)
    m2_b = ((values - mean_b) ** 2).sum(dim=0)
    n = count + n_b
    delta = mean_b - mean
    return (n, mean + delta * (n_b / n), m2 + m2_b + delta * delta * (count * n_b / n),
            torch.minimum(lo, values.amin(dim=0)), torch.maximum(hi, values.amax(dim=0)))
