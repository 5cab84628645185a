"""The benchmark's own traffic: action slabs and operating points drawn from
the run's seed, on the device, in a few large calls.

A traffic mix is a JSON file beside this module (``<traffic>.json``); this
one generator reads every mix.  Keys a mix may hold:

* ``chunk_steps``: steps per call of the entry point;
* ``pool``, ``hold_min``, ``hold_max``, ``amplitude``: a pool of ``pool``
  APRBS slabs ``(B, chunk_steps, A)``, handed out in turn, each channel
  holding a level drawn uniformly in ``[-amplitude, amplitude)`` for a
  duration drawn uniformly in ``[hold_min, hold_max)`` steps;
* ``inverse_repeat``: each slab's second half is its first half negated
  (an inverse-repeat sequence), so that every channel's slab sums to zero:
  a pool handed out again and again then pushes no drive steadily one way
  (an undamped pendulum would spin up chunk after chunk);
* ``initial``: ``{field: [lo, hi]}``, each drive's starting physical state
  drawn uniformly (fields left out keep the environment's default reset);
* ``references``: ``{field: [lo, hi]}``, each drive's tracked references;
* ``params``: ``{name: [lo, hi]}``, per-drive static parameters;
* ``checked_rows``: rows of each checked call that the comparison keeps
  (``0``: all of them).

The APRBS arithmetic follows ``exciting_environments_torch/ops/signals.py``
(levels and durations per channel, a right-sided search of every step in
the durations' running sum), with ``torch.Generator`` streams in place of
the program's threefry keys.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
#: rows of a slab drawn per block: bounds the search's temporaries
BLOCK_ROWS = 8192


def load(name: str) -> dict:
    """The traffic mix ``name``."""
    return json.loads((HERE / f"{name}.json").read_text())


def stream(seed: int, purpose: str, device) -> torch.Generator:
    """A generator on ``device`` for one purpose of one run: the same
    ``(seed, purpose)`` gives the same draws, different purposes are
    independent streams."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return gen


def uniform(gen: torch.Generator, shape, lo: float, hi: float, dtype: torch.dtype) -> torch.Tensor:
    """Uniform draws in ``[lo, hi)``, made in float64 and rounded to ``dtype``."""
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float64)
    return (u * (hi - lo) + lo).to(dtype)


def aprbs(gen: torch.Generator, batch: int, n_steps: int, action_dim: int, hold_min: int, hold_max: int,
          amplitude: float, dtype: torch.dtype, out: torch.Tensor = None) -> torch.Tensor:
    """An APRBS slab ``(batch, n_steps, action_dim)`` drawn in blocks of
    :data:`BLOCK_ROWS` rows, into ``out`` where given (else a new
    contiguous tensor)."""
    device = gen.device
    n_seg = n_steps // hold_min + 2
    out = torch.empty((batch, n_steps, action_dim), dtype=dtype, device=device) if out is None else out
    steps = torch.arange(n_steps, dtype=torch.int32, device=device)
    for r0 in range(0, batch, BLOCK_ROWS):
        rows = min(BLOCK_ROWS, batch - r0)
        levels = uniform(gen, (rows, n_seg, action_dim), -amplitude, amplitude, dtype)
        holds = torch.randint(hold_min, hold_max, (rows, n_seg, action_dim), generator=gen, device=device,
                              dtype=torch.int32)
        ends = torch.cumsum(holds, dim=1, dtype=torch.int32).transpose(1, 2).contiguous()  # (rows, A, S)
        idx = torch.searchsorted(ends, steps.expand(rows, action_dim, n_steps).contiguous(), right=True,
                                 out_int32=True).clamp_(max=n_seg - 1)
        out[r0:r0 + rows] = torch.gather(levels, 1, idx.transpose(1, 2).long())
    return out


def action_pool(gen: torch.Generator, mix: dict, batch: int, action_dim: int, dtype: torch.dtype) -> list:
    """The mix's pool of APRBS slabs."""
    steps = mix["chunk_steps"]
    draw = lambda n, out: aprbs(gen, batch, n, action_dim, mix["hold_min"], mix["hold_max"], mix["amplitude"], dtype,
                                out)
    if not mix.get("inverse_repeat"):
        return [draw(steps, None) for _ in range(mix["pool"])]
    pool, half = [], steps // 2
    for _ in range(mix["pool"]):
        slab = torch.empty((batch, steps, action_dim), dtype=dtype, device=gen.device)
        draw(half, slab[:, :half])
        torch.neg(slab[:, :half], out=slab[:, half:])
        pool.append(slab)
    return pool


def fields(gen: torch.Generator, ranges: dict, batch: int, dtype: torch.dtype) -> dict:
    """``{field: (batch,) uniform draws}`` for ``{field: [lo, hi]}``, in
    the mix's key order."""
    return {name: uniform(gen, (batch,), float(lo), float(hi), dtype) for name, (lo, hi) in ranges.items()}


def checked_rows(gen: torch.Generator, mix: dict, batch: int) -> torch.Tensor:
    """The sorted rows of each checked call that the comparison keeps."""
    n = int(mix.get("checked_rows", 0))
    if n <= 0 or n >= batch:
        return torch.arange(batch, device=gen.device)
    return torch.randperm(batch, generator=gen, device=gen.device)[:n].sort().values
