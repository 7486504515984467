"""BENCHMARK.json and the files it names: their required shapes, and every
cell, configuration and per-layer metric found by its file name."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench import harness
from perfbench.tests import tiny
from perfbench.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_bounds():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]


def test_cells_and_configs_found_by_name():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert (ROOT / "perfbench" / "reference"
                / f"{f['reference']}.py").is_file()
    for w in SPEC["workloads"]:
        assert w["chips"] == 1
        cell = harness.find_cell(ROOT, w["name"])
        assert cell.traffic["algorithm"] == "quafl"
        assert {"bits_gap"} <= set(cell.limits)
    for m in SPEC["per_layer"]:
        assert callable(harness.load_module(
            ROOT / "perfbench" / "metrics" / f"{m['name']}.py",
            f"x.{m['name']}").read)


def test_a_new_metric_file_is_read_without_editing_another(tmp_path):
    """A copy of the benchmark gains a metric: one new file and one new
    entry in BENCHMARK.json; a traced run reports it."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = dict(SPEC)
    spec["per_layer"] = SPEC["per_layer"] + [{
        "name": "rounds_traced", "unit": "rounds", "better": "higher",
        "source": "device_trace", "layer": "the H100",
        "moves": "rounds_per_s"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "perfbench" / "metrics" / "rounds_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.rounds)\n")
    res, _ = tiny.run(tiny.cell("mlp_quafl_paper", root=tmp_path),
                      trace=True)
    assert res["metrics"]["rounds_traced"]["value"] == 4.0


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_are_the_cells_own(name):
    cell = harness.find_cell(ROOT, name)
    assert cell.name == name and cell.bench == ROOT / "perfbench"
