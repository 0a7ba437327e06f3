"""``BENCHMARK.json`` against the benchmark's contract, and every file the
harness finds by name."""

import json
import os
import re

import pytest

from portbench.cell import NAME, UNIT
from portbench.tests.tiny import REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["portbench"]
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and cmd[1] == "portbench/run.py"
    for word in cmd:
        assert not word.startswith("/") and ".." not in word.split("/")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entry_keys_names_and_units(section, keys):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = set(e) - keys
        assert extra <= {"workloads"} and (
            not extra or section in ("end_to_end", "per_layer"))
        assert keys <= set(e)
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for text in ("why", "layer", "source"):
            if text in e and section != "end_to_end":
                assert 1 <= len(e[text]) <= 200
                assert "\n" not in e[text] and "\t" not in e[text]


def test_metric_names_unique_across_kinds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_end_to_end_bounds_and_sources():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_configs_files_and_cells():
    cells = BENCH["workloads"]
    used = {w["config"] for w in cells}
    assert {c["name"] for c in BENCH["configs"]} == used
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert os.path.isfile(os.path.join(
            REPO, os.path.splitext(c["file"])[0] + ".py"))
        assert c["reduced"] == [] and len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    for w in cells:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert os.path.isfile(os.path.join(REPO, "portbench", "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(REPO, "portbench", "limits",
                                           w["name"] + ".json"))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def _reports(cell):
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    per = {m["name"] for m in BENCH["per_layer"]
           if ("workloads" not in m and m["moves"] in e2e)
           or cell in m.get("workloads", [])}
    return e2e, per


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_and_a_layer(cell):
    e2e, per = _reports(cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and per


def test_moves_and_cell_lists_are_consistent():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E
        for c in m.get("workloads", sorted(cells)):
            assert c in cells
            e2e, _ = _reports(c)
            assert m["moves"] in e2e, (m["name"], c)


def test_one_layer_name_per_layer_and_readers_exist():
    for m in BENCH["per_layer"]:
        path = os.path.join(REPO, "portbench", "metrics", m["name"] + ".py")
        assert os.path.isfile(path), path
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        if "mfu" in m["name"].split("."):
            assert m["unit"] == "%"


def test_files_under_paths_are_named_from_name_characters():
    allowed = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for dirpath, dirs, files in os.walk(os.path.join(REPO, "portbench")):
        dirs[:] = [d for d in dirs if d not in ("_cache", "_runs",
                                                "__pycache__")]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), REPO)
            assert allowed.match(rel), rel
