"""Profiling, tracing and numerical-debugging utilities (counterpart of
``exciting_environments_tpu/utils/profiling.py``).

* :func:`trace` — a ``torch.profiler`` trace of the host and, where a CUDA
  device is present, the device, written into ``logdir`` as a Chrome trace
  (open it in Perfetto or ``chrome://tracing``).
* :func:`annotate` — a named region on the trace's timeline
  (``torch.profiler.record_function``).
* :class:`Timer` / :func:`benchmark_steps_per_sec` — wall-clock timing that
  waits for the device before reading the clock: ``torch.cuda.synchronize``
  where a CUDA tensor was produced, nothing on the CPU, where PyTorch runs
  synchronously; ``time.perf_counter`` in both cases.
* :func:`debug_nans` / :func:`checked` — NaN detection in autograd
  (``torch.autograd.set_detect_anomaly``) and explicit finite-checks on
  state containers.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from exciting_environments_torch.ops.kernels.checkpoint import tensors
from exciting_environments_torch.utils.checkpoint import leaves_with_path


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace into ``logdir``
    (``trace_<pid>_<n>.json``, a Chrome trace): host activity, and the
    device's where CUDA is available."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        _synchronize_all()
        prof.stop()
        n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name: str):
    """Named region on the profiler timeline (host and device)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Temporarily enable autograd's anomaly detection: a backward pass that
    produces NaN raises at the operation whose gradient produced it (the
    counterpart of ``jax_debug_nans``; forward values are checked with
    :func:`checked`)."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def checked(tree, name: str = "value"):
    """Raise if any floating leaf of ``tree`` contains non-finite entries
    (waits for the device)."""
    for path, leaf in leaves_with_path(tree):
        arr = torch.as_tensor(leaf)
        if arr.is_floating_point() and not bool(torch.isfinite(arr).all()):
            raise FloatingPointError(f"non-finite values in {name}{path}")
    return tree


def _synchronize(values):
    """Wait for the devices that hold any tensor of ``values``."""
    for device in {t.device for t in tensors(values) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


def _synchronize_all():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _MeasureHandle:
    """Collects the value(s) produced inside a :meth:`Timer.measure` block so
    the timer can wait for them at exit."""

    def __init__(self):
        self._pending = []

    def block(self, value):
        """Register ``value`` (any container of tensors) to be synchronized
        when the measure block exits; returns it unchanged for inline use."""
        self._pending.append(value)
        return value


@dataclass
class Timer:
    """Wall-clock timer that synchronizes the device before reading.

    The context manager yields a handle whose ``block(value)`` registers the
    work produced *inside* the block for synchronization at exit::

        timer = Timer()
        with timer.measure() as m:
            m.block(env.vmap_step(state, actions))

    ``result_to_block`` may alternatively be a ZERO-ARG CALLABLE evaluated at
    exit (e.g. ``lambda: out`` closing over a variable assigned in the block).
    Without either, the block waits for every CUDA device in use.
    """

    times: list = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self, result_to_block: Callable = None):
        handle = _MeasureHandle()
        t0 = time.perf_counter()
        yield handle
        if handle._pending:
            _synchronize(handle._pending)
        if result_to_block is not None:
            _synchronize(result_to_block())
        if not handle._pending and result_to_block is None:
            _synchronize_all()
        self.times.append(time.perf_counter() - t0)

    @property
    def best(self):
        return min(self.times)

    @property
    def mean(self):
        return sum(self.times) / len(self.times)


def benchmark_steps_per_sec(fn: Callable, *args, n_env_steps: int, repeats: int = 3, inputs=None):
    """Measure sustained env-steps/sec of ``fn``.

    The first call is excluded (kernel builds, warm-up); every later call is
    synchronized before the clock is read.  Returns ``(steps_per_sec,
    best_seconds)``.

    ``inputs`` (a list of distinct argument tuples, the first used for the
    warm-up) times each call on its own arguments; without it, ``fn(*args)``
    is repeated ``repeats`` times.
    """
    if inputs is None:
        inputs = [args] * (repeats + 1)
    _synchronize(fn(*inputs[0]))
    timer = Timer()
    for call_args in inputs[1:]:
        with timer.measure() as m:
            m.block(fn(*call_args))
    return n_env_steps / timer.best, timer.best
