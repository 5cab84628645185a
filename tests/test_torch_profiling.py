"""The port's profiling utilities (``utils/profiling.py``) on the CPU:
``trace`` writes a trace file, ``annotate`` regions nest inside it, the
timers return positive times, and the finite-checks raise on NaN."""

import json
import os

import pytest
import torch

import exciting_environments_torch as P
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import profiling

F64 = dict(device="cpu", dtype=torch.float64)


def _env():
    env = P.Pendulum(batch_size=8, **F64)
    _, state = env.vmap_reset(prng.split(prng.PRNGKey(0, "cpu"), 8))
    return env, state, 0.3 * torch.ones((8, 1), dtype=torch.float64)


def test_trace_writes_a_file_with_nested_annotations(tmp_path):
    env, state, a = _env()
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                env.vmap_step(state, a)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / "trace" / files[0]).read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("outer", "inner") and "dur" in e}
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_timer_and_steps_per_sec_are_positive():
    env, state, a = _env()
    timer = profiling.Timer()
    for _ in range(3):
        with timer.measure() as m:
            m.block(env.vmap_step(state, a))
    with timer.measure(lambda: env.vmap_step(state, a)):
        pass
    assert len(timer.times) == 4 and timer.best > 0 and timer.mean >= timer.best
    rate, best = profiling.benchmark_steps_per_sec(lambda s: env.vmap_step(s, a), state, n_env_steps=8)
    assert rate > 0 and best > 0 and abs(rate * best - 8) < 1e-6
    inputs = [(state,), (state,)]
    rate2, _ = profiling.benchmark_steps_per_sec(lambda s: env.vmap_step(s, a), n_env_steps=8, inputs=inputs)
    assert rate2 > 0


def test_checked_and_debug_nans():
    env, state, a = _env()
    # a fresh state's references are NaN until drawn: check the physics
    assert profiling.checked(state.physical_state) is state.physical_state
    bad = env.vmap_step(state, a)[1]
    bad.physical_state.omega = bad.physical_state.omega * float("nan")
    with pytest.raises(FloatingPointError, match=r"state\['omega'\]"):
        profiling.checked(bad.physical_state, "state")
    before = torch.is_anomaly_enabled()
    with profiling.debug_nans():
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    assert torch.is_anomaly_enabled() == before
