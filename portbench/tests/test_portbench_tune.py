"""The cell ``pmsm-brusa-pi-tune-t256`` at a size a CPU run holds: its
driver against the plain tuning reference in float64 (the gains a job's
first call ran with, its loss, its gradient and its step), the jobs it
runs, the train block it reads, its configuration's work counts against
``chip_smoke.py``'s, a gradient with one term left out failing
``grad_gap``, a step not taken or uphill failing ``step_gap``, a
non-finite call failing ``loss_gap``, and the control (the reference in
bfloat16) failing a limit that the program's float32 run meets.  The tests marked ``gpu`` run on
the card: a call routed to the eager replay fails ``launch_gap`` alone, and
the control at the cell's own size."""

import json
import math

import pytest
import torch

import chip_smoke as cs
from exciting_environments_torch.ops.kernels import pmsm_closed_loop, pmsm_closed_loop_adjoint
from portbench import harness
from portbench.work.peaks import least_seconds

CELL = "pmsm-brusa-pi-tune-t256"
SMALL = {"batch": 16, "chunk_steps": 12}
SEED = 2**31 + 77


def driver(dtype="float64", seed=2**31 + 5, size=None, device="cpu"):
    cell = harness.Cell(CELL, {**(SMALL if size is None else size), "dtype": dtype})
    return harness.load_module(harness.HERE / "drivers" / f"{cell.workload['driver']}.py").Driver(cell, seed, device)


def run(size=None):
    return harness.run_cell(CELL, SEED, 0.3, False, "cpu", overrides={**(size or SMALL), "dtype": "float32"},
                            log=lambda line: None)


def test_driver_meets_the_reference_in_float64():
    d = driver()
    d.warmup(3)
    readings = d.compare(torch.float64)
    assert len(readings) == 1 and all(v <= 1e-12 for r in readings for v in r.values()), readings


def test_jobs_restart_from_the_starting_gains():
    """Every ``iterations``-th call starts a new job: the starting gains and a
    fresh optimizer, so the job's first loss is the first job's; each
    finished job is recorded with its first and last loss, and the checked
    calls hold their job's first iteration."""
    d = driver(size={"batch": 8, "chunk_steps": 4})
    assert d.job_length == 12 and d.lr == 0.1
    d.warmup(25)
    assert len(d.jobs) == 2 and d.jobs[0] == d.jobs[1]
    assert torch.equal(d.before, d.start_gains)  # call 25 ran with the starting gains
    gains, _, step = d.job_first
    assert torch.equal(gains, d.start_gains) and d.job_first_loss == d.jobs[0][0] and bool((step != 0).all())
    assert d.finite and "every call's loss finite: True" in d.describe()


def test_the_driver_reads_the_train_block():
    """The configuration's ``train`` block is what the driver runs: Adam's
    lr, the loss factory by name, the job's length; the traffic's policy
    holds the starting gains."""
    cell = harness.Cell(CELL)
    assert set(cell.config["train"]) == {"iterations", "lr", "loss"} and cell.config["reduced"] == []
    d = driver(size={"batch": 8, "chunk_steps": 4})
    d.warmup(1)
    assert d.opt.param_groups[0]["lr"] == cell.config["train"]["lr"] == 0.1
    assert d.loss_fn.__qualname__.startswith(cell.config["train"]["loss"])
    policy = cell.traffic["policy"]
    assert d.start_gains.tolist() == [*sum(policy["K"], []), 0.0, 0.0, *sum(policy["Ki"], [])]


def test_a_step_not_taken_or_uphill_fails_step_gap(monkeypatch):
    """An optimizer step that leaves the gains where they were reads 1, one
    that climbs the gradient 2: ``step_gap`` fails both, with the loss and
    the gradient right."""
    adam = torch.optim.Adam
    for plant, reading in ((dict(lr=0.0), 1.0), (dict(maximize=True), 2.0)):
        monkeypatch.setattr(torch.optim, "Adam", lambda params, lr, _p=plant: adam(params, **{"lr": lr, **_p}))
        result = run()
        checks = result["checks"]
        assert not result["correct"] and abs(checks["step_gap"]["value"] - reading) < 1e-3, checks
        assert all(checks[k]["value"] <= checks[k]["limit"] for k in ("loss_gap", "grad_gap")), checks


def test_a_non_finite_call_fails_loss_gap():
    """A call whose loss is not finite (a drive gone to infinity) makes
    every reading's ``loss_gap`` NaN."""
    d = driver(size={"batch": 8, "chunk_steps": 4})
    d.warmup(2)
    d.finite = False
    assert all(math.isnan(r["loss_gap"]) for r in d.compare(torch.float64))


def test_work_counts_match_chip_smoke():
    """The adjoint's count is ``chip_smoke.py``'s row 4i at the cell's
    shapes; its least time is bound by bytes."""
    cell = harness.Cell(CELL)
    shapes = driver("float32").shapes()
    shapes.update(batch=cell.batch, steps=cell.steps, saves=cell.steps)
    work = harness.load_module(harness.HERE / "work" / "pmsm_closed_loop_adjoint.py")
    counts = cell.config["work"]["pmsm_closed_loop_adjoint"]
    ops, nbytes = work.work(counts, shapes)
    assert (counts["drive_ops_per_step"], work.law_ops(10, True), counts["ops_final"]) == (
        cs.ADJ_OPS, cs.ADJ_LAW_OPS, cs.ADJ_OPS_FINAL)
    assert ops == ((cs.ADJ_OPS + cs.ADJ_LAW_OPS) * 256 + cs.ADJ_OPS_FINAL) * cell.batch
    assert nbytes == 4 * (cell.batch * 256 * 11 + cell.batch * 15 + 2 * 42 + counts["table_values"])
    least, by = least_seconds(ops, nbytes)
    assert by == "bytes" and round(least * 1e3, 4) == 0.2215
    angles = harness.load_module(harness.HERE / "work" / "pmsm_angles.py")
    assert angles.work(cell.config["work"]["pmsm_angles"], shapes) == ((6 * 256 + 1) * cell.batch,
                                                                         4 * cell.batch * 259)


def test_a_gradient_with_a_term_left_out_is_not_correct(monkeypatch):
    """The backward drops the integral gains' gradient of the second action
    (``Ki``'s last row): ``grad_gap`` catches it."""
    original = pmsm_closed_loop.PmsmClosedLoopVJP._backward

    def backward(ctx, grads):
        out = list(original(ctx, grads))
        n_refs, nc = len(ctx.cfg.split(ctx.saved_tensors[: ctx.cfg.n_in])[2]), ctx.cfg.n_carry
        at = 1 + 5 + 1 + n_refs + nc
        out[at] = out[at].clone()
        out[at][-10:] = 0
        return tuple(out)

    monkeypatch.setattr(pmsm_closed_loop.PmsmClosedLoopVJP, "_backward", staticmethod(backward))
    result = run()
    assert not result["correct"] and result["checks"]["grad_gap"]["value"] > result["checks"]["grad_gap"]["limit"]
    assert result["checks"]["loss_gap"]["value"] <= result["checks"]["loss_gap"]["limit"]


def test_program_meets_the_limits_and_the_control_fails():
    """The program's float32 run is correct; the reference in bfloat16 in its
    place fails a limit."""
    result = run()
    assert result["correct"], result["checks"]
    d = driver("float32")
    d.warmup(2)
    limits = harness.Cell(CELL).workload["limits"]
    readings = d.compare(control=True)
    assert any(not math.isfinite(v) or v > limits[k] for r in readings for k, v in r.items()), readings


@pytest.mark.gpu
def test_a_call_routed_to_the_replay_fails_launch_gap(card, monkeypatch):
    """On the card, a call whose backward replays the plain step (the
    adjoint's scope refused) gives right answers and fails ``launch_gap``."""
    monkeypatch.setattr(pmsm_closed_loop_adjoint, "adjoint_scope", lambda *a, **k: "inputs")
    result = harness.run_cell(CELL, SEED, 2.0, False, card, overrides={"batch": 4096, "chunk_steps": 32},
                              log=lambda line: None)
    assert not result["correct"] and result["checks"]["launch_gap"]["value"] > 0
    assert all(result["checks"][k]["value"] <= result["checks"][k]["limit"] for k in ("loss_gap", "grad_gap"))


@pytest.mark.gpu
def test_control_fails_at_the_cells_size(card):
    d = driver("float32", size={}, device=card)
    d.warmup(2)
    limits = json.loads((harness.HERE / "workloads" / f"{CELL}.json").read_text())["limits"]
    readings = d.compare(control=True)
    assert any(not math.isfinite(v) or v > 10 * limits[k] for r in readings for k, v in r.items()), readings
