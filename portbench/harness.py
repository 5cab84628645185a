"""The benchmark's harness: one run of one cell.

Everything is found by name: the cell's ``workloads/<cell>.json`` names
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its driver (``drivers/<driver>.py``, the entry
point the window drives) and the kernel libraries it launches
(``work/<library>.py`` count their work); ``BENCHMARK.json`` names the
metrics, each read by ``end_to_end/<metric>.py`` or
``layer_metrics/<metric>.py``.  A run builds the cell's kernel libraries,
lets the driver make its inputs from the seed and set up the program, warms
up, measures for the window's seconds (traced: the profiler over the
window's first calls), then compares what the window produced with the
plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench.tracing import TraceSummary
from portbench.traffic import generator
from portbench.window import Window

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "exciting_environments_tpu")
#: calls made before the window: every shape of the window, and the
#: comparison's first case (the start, from the benchmark's own inputs)
WARMUP_CALLS = 2
#: calls of the window that the comparison checks, drawn from the seed
CHECKED_CALLS = 4
#: calls of the window that a traced run's profiler covers
TRACED_CALLS = 32


class WindowClosed(Exception):
    """Raised from a loop's hook to end the window."""


class MissingReading(Exception):
    """A traced run found nothing to read for a per-layer metric that its
    cell reports."""


def reader(kind: str, metric: str):
    """The reader of ``metric``: ``<kind>/<metric>.py``."""
    return load_module(HERE / kind / f"{metric}.py")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path):
    """A module of the benchmark loaded from its file (names may hold
    ``-`` and ``.``)."""
    path = Path(path)
    name = "portbench_" + "_".join(path.relative_to(HERE).with_suffix("").parts).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell's workload, configuration and traffic mix, with ``overrides``
    (``{"batch": ..., "dtype": ..., "chunk_steps": ..., "pool": ...}``)
    for small runs in the tests."""

    def __init__(self, name: str, overrides: dict = None):
        overrides = dict(overrides or {})
        self.name = name
        self.benchmark = load_json(REPO / "BENCHMARK.json")
        self.workload = load_json(HERE / "workloads" / f"{name}.json")
        self.config = load_json(HERE / "configs" / f"{self.workload['config']}.json")
        self.traffic = generator.load(self.workload["traffic"])
        self.batch = int(overrides.pop("batch", self.config["batch"]))
        self.dtype = getattr(torch, overrides.pop("dtype", self.config["dtype"]))
        self.traffic.update(overrides)
        self.steps = int(self.traffic["chunk_steps"])
        self.kernels = list(self.workload["kernels"])

    def end_to_end(self):
        return [m for m in self.benchmark["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        return [m for m in self.benchmark["per_layer"] if self.name in m.get("workloads", [self.name])]


def make_env(ex, cell: Cell, device, per_drive: dict = None):
    """The configuration's environment (``env`` and ``kwargs``; a key of
    ``enum_kwargs`` names the program's enum its value is a member of), with
    the configuration's ``static_params`` and ``per_drive`` ones (``(B,)``
    tensors) over the defaults that the environment itself completes for
    these arguments."""
    cfg = cell.config
    cls = getattr(ex, cfg["env"])
    kwargs = dict(cfg["kwargs"])
    for key, enum in cfg.get("enum_kwargs", {}).items():
        kwargs[key] = getattr(ex, enum)[kwargs[key]]
    static = {**cfg.get("static_params", {}), **(per_drive or {})}
    params = None
    if static:
        defaults = cls(batch_size=1, device="cpu", **kwargs).env_properties.static_params
        params = {**vars(defaults), **static}
    return cls(batch_size=cell.batch, device=device, dtype=cell.dtype, static_params=params, **kwargs)


def start_state(env, physical: dict, references: dict = None):
    """The environment's default reset with the given physical fields and
    tracked references in place."""
    from exciting_environments_torch.core import structures

    _, state = env.vmap_reset()
    phys = structures.replace(state.physical_state, **physical)
    ref = structures.replace(state.reference, **(references or {}))
    return structures.replace(state, physical_state=phys, reference=ref)


def card_line(device) -> str:
    """The card's name, count and, where ``nvidia-smi`` answers, its clocks
    and power limit."""
    if torch.device(device).type != "cuda":
        return f"device {device} (no card)"
    line = f"card {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        line += f"; sm clock, max sm clock, power draw, power limit: {smi.stdout.strip().splitlines()[0]}"
    except (OSError, subprocess.SubprocessError, IndexError):
        line += "; nvidia-smi gave no reading"
    return line


def forbidden_modules() -> list:
    """The forbidden top-level modules that ``sys.modules`` holds, compared
    by whole top-level name."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class RunSummary:
    """What the end-to-end readers (``end_to_end/<metric>.py``) take."""

    def __init__(self, setup_s, window: Window, steps_per_call: int, peak_bytes: int):
        self.setup_s = setup_s
        self.window_s = window.elapsed
        self.calls = window.calls
        self.latencies_s = list(window.latencies)
        self.steps_per_call = steps_per_call
        self.peak_bytes = peak_bytes


def launch_counters(libraries) -> dict:
    """The program's launch counter of each kernel library
    (``ops/kernels/<library>.py``'s ``KernelLibrary``)."""
    from exciting_environments_torch.ops.kernels.stepper import KernelLibrary

    found = {}
    for lib in libraries:
        module = importlib.import_module(f"exciting_environments_torch.ops.kernels.{lib}")
        found[lib] = next(v for v in vars(module).values() if isinstance(v, KernelLibrary) and v.name == lib)
    return found


def kernel_work(cell: Cell, shapes: dict) -> dict:
    """``{library: (kernel symbol, least seconds per call, what bounds it,
    operations, bytes)}`` for the cell's kernels, from ``work/<library>.py``."""
    from portbench.work.peaks import least_seconds

    out = {}
    for lib in cell.kernels:
        module = load_module(HERE / "work" / f"{lib}.py")
        ops, nbytes = module.work(cell.config["work"][lib], shapes)
        least, by = least_seconds(ops, nbytes)
        out[lib] = (module.KERNEL_SYMBOL, least, by, ops, nbytes)
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda", t_start: float = None,
             overrides: dict = None, log=print):
    """One run of cell ``name``; returns the result line's object, or
    ``None`` where a forbidden module was loaded (named on standard error).
    ``log`` takes the lines printed before the result."""
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("torch import, CUDA start and harness import", time.perf_counter())]
    cell = Cell(name, overrides)
    cuda = torch.device(device).type == "cuda"
    log(f"[portbench] cell {name} seed {seed} seconds {seconds} trace {int(trace)}; {card_line(device)}")
    if cuda:
        from exciting_environments_torch.ops.kernels import stepper

        t0 = time.perf_counter()
        stepper.build_all(cell.kernels)
        log(f"[portbench] kernel libraries {cell.kernels} ready in {time.perf_counter() - t0:.3f} s; "
            f"build times {stepper.BUILD_TIMES or 'none (built before)'}")
    marks.append(("program import and kernel libraries", time.perf_counter()))
    driver = load_module(HERE / "drivers" / f"{cell.workload['driver']}.py").Driver(cell, seed, device)
    sync(device)
    marks.append(("inputs and program set-up", time.perf_counter()))
    work = kernel_work(cell, driver.shapes())
    for lib, (symbol, least, by, ops, nbytes) in work.items():
        log(f"[portbench] {lib} ({symbol}): {ops} operations, {nbytes} bytes per call; least time "
            f"{least * 1e3!r} ms ({by}) at 67 TFLOP/s float32 and 3.35 TB/s")
    if hasattr(driver, "describe"):
        log(f"[portbench] {driver.describe()}")
    driver.warmup(WARMUP_CALLS)
    profiler = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities):  # the tracer's own first start, outside the window
            driver.warmup(1)
        profiler = profile(activities=activities)
    sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    parts = ", ".join(f"{label} {t - t_prev:.3f} s" for (label, t), (_, t_prev) in
                      zip(marks, [("start", t_start)] + marks[:-1]))
    log(f"[portbench] set-up {setup_s!r} s: {parts}")

    window = Window(seconds, seed, CHECKED_CALLS, profiler, TRACED_CALLS)
    segments = lambda: torch.cuda.memory_stats().get("segment.all.allocated", 0) if cuda else 0
    segments_before = segments()
    counters = launch_counters(cell.kernels)
    launches_before = {lib: sum(c.launches.values()) for lib, c in counters.items()}
    if profiler is not None:
        profiler.start()
    window.open()
    driver.run_window(window)
    sync(device)
    if window.profiler is not None:
        window.profiler.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launches = {lib: sum(c.launches.values()) - launches_before[lib] for lib, c in counters.items()}
    log(f"[portbench] window {window.elapsed!r} s, {window.calls} calls of {driver.steps_per_call} env-steps; "
        f"{segments() - segments_before} device allocations (cudaMalloc) in it; peak {peak} bytes; calls per "
        f"tenth of it {window.tenths()}; kernel launches in it (the program's counters) {launches}")
    found = forbidden_modules()
    if found:
        print(f"[portbench] forbidden modules loaded: {found}", file=sys.stderr)
        return None

    driver.release()
    t0 = time.perf_counter()
    readings = driver.compare(torch.float64)
    log(f"[portbench] comparison of {len(readings)} calls with the reference in {time.perf_counter() - t0:.3f} s")
    limits = cell.workload["limits"]
    within = lambda value, name: math.isfinite(value) and value <= limits[name]
    checks = {name: {"value": max(r[name] for r in readings), "limit": float(limits[name])} for name in limits}
    failed = sum(not all(within(v, name) for name, v in r.items()) for r in readings)
    # every call of the window goes through the cell's kernels, once each (on
    # the CPU the program takes its plain path and launches none)
    expected = window.calls if cuda else 0
    checks["launch_gap"] = {"value": float(max(abs(n - expected) for n in launches.values())), "limit": 0.0}
    failed += checks["launch_gap"]["value"] != 0

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0, "attempted": window.calls + driver.warmed, "failed": failed}
    if trace:
        summary = TraceSummary(profiler.events(), {lib: (w[0], w[1]) for lib, w in work.items()})
        where = "; ".join(f"{lib} kernel events per traced call {summary.placement(lib)}" for lib in cell.kernels)
        log(f"[portbench] traced {len(summary.calls)} calls, {len(summary.device)} device events; {where}")
        metrics = {}
        for m in cell.per_layer():
            value = reader("layer_metrics", m["name"]).read(summary)
            if value is None:
                raise MissingReading(f"the trace of cell {name} ({len(summary.calls)} calls, {len(summary.device)} "
                                     f"device events; {where}) holds nothing for its per-layer metric {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result.update(metrics=metrics, device=device_info, breakdown=summary.breakdown())
    else:
        run = RunSummary(setup_s, window, driver.steps_per_call, peak)
        metrics = {m["name"]: {"value": reader("end_to_end", m["name"]).read(run), "unit": m["unit"]}
                   for m in cell.end_to_end()}
        result.update(metrics=metrics, device=device_info)
    result["checks"] = checks
    return result


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (inclusive method) of ``values``."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[int(q) - 1]
