"""The benchmark's data, found by name: a cell of ``BENCHMARK.json``, its
configuration (``configs/<config>.json`` and the plain reference beside it,
``configs/<config>.py``), its traffic mix (``traffic/<traffic>.json``), the
limits of its comparison (``limits/<cell>.json``) and its per-layer metrics
(``metrics/<metric>.py``, each a ``read(result, cell)``). Nothing here
names a cell, a configuration or a metric: a later cell brings its own
files and needs no edit of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PKG = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    root: str
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    reference: object       # the configuration's plain reference module

    @property
    def chips(self) -> int:
        return int(self.entry.get("chips", 1))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A Python file of the benchmark's, loaded by its path (names of files
    may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_dyn_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str, e2e_names: Optional[set] = None) -> bool:
    """A metric's cells: its ``workloads`` list; without one, an end-to-end
    metric is every cell's and a per-layer metric that of every cell that
    reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_names is None:
        return True
    return metric.get("moves") in e2e_names


def load_cell(root: str, workload: str,
              manifest: str = "BENCHMARK.json") -> Cell:
    bench = _load_json(os.path.join(root, manifest))
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"no workload {workload!r} in {manifest}; cells: "
                         f"{sorted(entries)}")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[entry["config"]]
    config = _load_json(os.path.join(root, conf_entry["file"]))
    base = os.path.join(root, "portbench")
    traffic = _load_json(os.path.join(base, "traffic",
                                      entry["traffic"] + ".json"))
    limits = _load_json(os.path.join(base, "limits", workload + ".json"))
    ref_path = os.path.splitext(os.path.join(root, conf_entry["file"]))[0] \
        + ".py"
    reference = load_module(ref_path, entry["config"])
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m, workload, names)]
    return Cell(root, workload, entry, config, traffic, limits, e2e,
                per_layer, reference)


def metric_reader(root: str, name: str):
    return load_module(os.path.join(root, "portbench", "metrics",
                                    name + ".py"), name)


def read_per_layer(cell: Cell, result) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(cell.root, m["name"]).read(result, cell)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
