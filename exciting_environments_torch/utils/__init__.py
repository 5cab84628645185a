"""Normalization and simulation-property (de)serialization (counterpart of
``exciting_environments_tpu/utils/__init__.py``)."""

from __future__ import annotations

import json
from dataclasses import asdict

from exciting_environments_torch.core.structures import dataclass


@dataclass
class MinMaxNormalization:
    """Min-max mapping between physical units and the normalized [-1, 1] band.

    ``min``/``max`` may be Python scalars or per-batch ``(batch_size,)``
    tensors.  Scalars stay Python numbers, so expressions over them fold in
    float64 before they meet a tensor, as in the JAX package.
    """

    min: float
    max: float

    def normalize(self, denormalized_value):
        return 2 * (denormalized_value - self.min) / (self.max - self.min) - 1

    def denormalize(self, normalized_value):
        return (normalized_value + 1) / 2 * (self.max - self.min) + self.min


def dump_sim_properties_to_json(params, action_normalizations, physical_normalizations, tau, filename):
    """Persist (static params, normalizations, tau) as JSON."""
    data = {
        "params": params,
        "action_normalizations": {k: asdict(v) for k, v in action_normalizations.items()},
        "physical_normalizations": {k: asdict(v) for k, v in physical_normalizations.items()},
        "tau": tau,
    }
    with open(filename, "w") as f:
        json.dump(data, f, indent=4)


def load_sim_properties_from_json(filename):
    """Load (params, action_norms, physical_norms, tau) from a JSON fixture."""
    with open(filename, "r") as f:
        data = json.load(f)
    action_normalizations = {k: MinMaxNormalization(**v) for k, v in data["action_normalizations"].items()}
    physical_normalizations = {k: MinMaxNormalization(**v) for k, v in data["physical_normalizations"].items()}
    return data["params"], action_normalizations, physical_normalizations, data["tau"]
