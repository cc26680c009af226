"""Every configuration, cell and metric is found by name from its own file,
BENCHMARK.json keeps to the benchmark's contract, and a cell added as
files only is picked up with no code edit."""

import json
import os
import re
import shutil

import pytest
import time
import torch

from conftest import ROOT, SMALL

from kzgbench import harness
from kzgbench.reference.system import ReferenceSystem

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["kzgbench"]
    assert bench["command"][:3] == ["python3", "-m", "kzgbench.run"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) < 64 * 1024


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"kzgbench/configs/{c['name']}.json"
        own = harness.load_json(ROOT, c["file"])
        assert own["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in own for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in bench["workloads"])


@pytest.mark.parametrize("cell", list(SMALL))
def test_cell_found_by_name(bench, cell):
    found = harness.find_cell(bench, cell)
    assert found.config["coefficients"] > 0
    assert found.mix["kind"] in ("open", "verify")
    assert harness.kind_module(found.mix["kind"]).check
    assert {m["name"] for m in found.end_to_end} >= {"setup_s"}
    assert len(found.end_to_end) >= 2 and found.per_layer


def test_workloads(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(ROOT, "kzgbench", "traffic", f"{w['traffic']}.json"))


def test_metrics(bench):
    names = set()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert callable(harness.metric_reader(m["name"]))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    for cell in cells:
        found = harness.find_cell(bench, cell)
        assert "setup_s" in {m["name"] for m in found.end_to_end}


def test_cell_added_as_files_only(bench, tmp_path):
    """A copy of the benchmark with one more cell, its traffic mix and its
    file, and no code edit: the harness finds it and runs it."""
    here = tmp_path / "kzgbench"
    shutil.copytree(os.path.join(ROOT, "kzgbench"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = json.loads((here / "traffic" / "open.json").read_text())
    (here / "traffic" / "open_small.json").write_text(json.dumps({**mix, "pool": 3}))
    (here / "workloads" / "plonk_2e24.open_small.json").write_text(json.dumps(
        {"config": "plonk_2e24", "traffic": "open_small"}))
    extended = json.loads(json.dumps(bench))
    extended["workloads"].append({"name": "plonk_2e24.open_small", "config": "plonk_2e24",
                                  "traffic": "open_small", "chips": 1, "why": "test"})
    for m in extended["end_to_end"] + extended["per_layer"]:
        if "plonk_2e24.open" in m.get("workloads", []):
            m["workloads"].append("plonk_2e24.open_small")
    cell = harness.find_cell(extended, "plonk_2e24.open_small", here=str(here))
    assert cell.mix["pool"] == 3 and cell.config["coefficients"] == 2 ** 24
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    cell.config = {**cell.config, **SMALL["plonk_2e24.open"][0]}
    out = harness.run_cell(cell, 77, 0.3, False, ReferenceSystem(torch.device("cpu")),
                           torch.device("cpu"), time.perf_counter())
    assert out["correct"] and {"setup_s", "open_s"} <= set(out["metrics"])


def test_cell_file_must_agree(bench, tmp_path):
    here = tmp_path / "kzgbench"
    shutil.copytree(os.path.join(ROOT, "kzgbench"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (here / "workloads" / "plonk_2e24.open.json").write_text(json.dumps(
        {"config": "eip4844_blob", "traffic": "open"}))
    with pytest.raises(ValueError):
        harness.find_cell(bench, "plonk_2e24.open", here=str(here))
    with pytest.raises(KeyError):
        harness.find_cell(bench, "no.such.cell")


def test_metric_added_as_a_file(tmp_path, bench):
    """A per-layer metric is one new module and one entry: a traced run of
    the cell reports it, with no code edit."""
    here = tmp_path / "kzgbench"
    shutil.copytree(os.path.join(ROOT, "kzgbench"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (here / "metrics" / "open.jobs_n.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    extended = json.loads(json.dumps(bench))
    extended["per_layer"].append({"name": "open.jobs_n", "unit": "jobs", "better": "higher",
                                  "source": "host_clock", "layer": "kzg protocol",
                                  "moves": "open_s", "workloads": ["plonk_2e24.open"]})
    cell = harness.find_cell(extended, "plonk_2e24.open", here=str(here))
    cell.config = {**cell.config, **SMALL["plonk_2e24.open"][0]}
    out = harness.run_cell(cell, 78, 0.3, True, ReferenceSystem(torch.device("cpu")),
                           torch.device("cpu"), time.perf_counter())
    assert out["metrics"]["open.jobs_n"]["value"] == out["attempted"]
