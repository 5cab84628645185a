"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of the benchmark."""

import json
import re
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.traffic import generator

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and ".." not in path and (REPO / path).is_dir()
    # a full check of 24 cells: 2 + 14 runs a cell, each with 60 s more, 2 x 90 s a cell and 1,200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= len(BENCH["workloads"]) <= 24


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in BENCH["end_to_end"]]
             + [m["name"] for m in BENCH["per_layer"]] + [w["traffic"] for w in BENCH["workloads"]]
             + [w["config"] for w in BENCH["workloads"]] + [k for c in BENCH["configs"] for k in c["reduced"]])
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    for text in [c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]] + \
            [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in CELLS:
        assert any(m["name"] != "setup_s" for m in harness.Cell(cell).end_to_end())
        assert harness.Cell(cell).per_layer()


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert c["file"].startswith("portbench/")
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert w["config"] in configs and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.Cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.workload["config"] == entry["config"] and c.workload["traffic"] == entry["traffic"]
    assert c.workload["why"] == entry["why"] and c.workload["chips"] == entry["chips"]
    assert (harness.HERE / "drivers" / f"{c.workload['driver']}.py").is_file()
    assert (harness.HERE / "reference" / f"{c.config['reference']}.py").is_file()
    for lib in c.kernels:
        assert hasattr(harness.load_module(harness.HERE / "work" / f"{lib}.py"), "work")
        assert lib in c.config["work"]
    for m in c.end_to_end():
        assert hasattr(harness.reader("end_to_end", m["name"]), "read")
    for m in c.per_layer():
        assert hasattr(harness.reader("layer_metrics", m["name"]), "read")
        assert any(e["name"] == m["moves"] for e in c.end_to_end())
    assert set(c.workload["limits"]) and all(v >= 0 for v in c.workload["limits"].values())


@pytest.mark.parametrize("traffic", sorted({w["traffic"] for w in BENCH["workloads"]}))
def test_traffic_repeats_for_a_seed(traffic):
    mix = {**generator.load(traffic), "pool": 2, "chunk_steps": 64}

    def draw(seed):
        gen = generator.stream(seed, "inputs", "cpu")
        out = []
        for key in ("initial", "references", "params"):
            out += list(generator.fields(gen, mix.get(key, {}), 300, torch.float32).values())
        if "pool" in generator.load(traffic):
            out += generator.action_pool(gen, mix, 300, 2, torch.float32)
        return out

    a, b, c = draw(2**31 + 11), draw(2**31 + 11), draw(2**31 + 12)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_aprbs_holds_levels():
    gen = generator.stream(5, "inputs", "cpu")
    slab = generator.aprbs(gen, 64, 500, 2, 10, 100, 0.4, torch.float64)
    assert slab.shape == (64, 500, 2) and slab.abs().max() < 0.4
    changes = (slab[:, 1:] != slab[:, :-1]).sum(dim=1)
    assert int(changes.max()) <= 500 // 10 and int(changes.min()) >= 500 // 100 - 1


def test_a_run_without_a_card_fails_and_prints_no_result():
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = subprocess.run([sys.executable, str(REPO / "portbench" / "run.py"), "--workload", CELLS[0], "--seed",
                           str(2**31 + 3), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert done.returncode != 0 and "{" not in done.stdout
