"""Minimal gym-like spaces (counterpart of ``exciting_environments_tpu/core/spaces.py``)."""

from __future__ import annotations

from typing import Any, Tuple

import torch


class Space:
    """Abstract observation/action space."""

    def sample(self, generator: torch.Generator):
        raise NotImplementedError

    def contains(self, x: Any) -> bool:
        raise NotImplementedError


class Box(Space):
    """Axis-aligned box with uniform sampling from an explicit generator."""

    def __init__(self, low: float, high: float, shape: Tuple[int], dtype: torch.dtype = torch.float32):
        self.low = low
        self.high = high
        self.dtype = dtype
        self.shape = shape

    def sample(self, generator: torch.Generator):
        u = torch.rand(self.shape, generator=generator, dtype=torch.float64, device=generator.device)
        return (u * (self.high - self.low) + self.low).to(self.dtype)

    def contains(self, x: Any) -> bool:
        x = torch.as_tensor(x)
        return bool(torch.all(x >= self.low)) and bool(torch.all(x <= self.high))
