"""Each cell's path, run end to end on the CPU at a tiny size against the
plain reference; the harness finding a new configuration, traffic mix and
per-layer metric by name; and the faults the comparison has to catch."""

import hashlib
import json
import os
import shutil

import pytest

from portbench.tests.tiny import REPO, run_cpu, tiny_copy

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]

# CPU-sized limits: at B=4 a step's few rows leave many gradients near
# their round-off, so the tiny copy holds the sound run to looser numbers
# than the card's cells; the faults still read far above them
TINY_LIMITS = {"loss": 0.05, "grad1_d_median": 0.01, "grad1_d_worst": 0.01,
               "grad1_g_median": 0.01, "grad1_g_worst": 0.01,
               "change3_median": 0.1, "change3_worst": 0.1,
               "img": 1e-4, "score": 1e-4, "rank": 1e-4, "nn": 1e-4}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tiny_copy(str(tmp_path_factory.mktemp("tiny") / "b"))
    ldir = os.path.join(root, "portbench", "limits")
    for name in os.listdir(ldir):
        path = os.path.join(ldir, name)
        with open(path) as f:
            lim = json.load(f)
        with open(path, "w") as f:
            json.dump({k: TINY_LIMITS[k] for k in lim}, f)
    return root


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_matches_the_reference(tiny, cell):
    rc, line, err = run_cpu(tiny, cell)
    assert rc == 0 and line is not None, err[-3000:]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, err[-3000:]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    lines = err.strip().splitlines()
    n = len(line["checks"])
    assert all(ln.startswith("check ") for ln in lines[-n:])


def test_traced_run_reports_per_layer_metrics(tiny):
    rc, line, err = run_cpu(tiny, "train32.f32", trace=1)
    assert rc == 0 and line is not None, err[-3000:]
    assert {"data_ms.train", "dispatch_ms.train", "mfu.train"} <= set(
        line["metrics"])
    assert "breakdown" in line and "window_s" in line["device"]


def _digest(root):
    out = {}
    for dirpath, dirs, files in os.walk(os.path.join(root, "portbench")):
        dirs[:] = [d for d in dirs if d not in ("_runs", "__pycache__")]
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_config_traffic_and_metric_are_found_by_name(tiny, tmp_path):
    """A later change adds a cell by adding files and entries only."""
    root = str(tmp_path / "b")
    shutil.copytree(tiny, root)
    before = _digest(root)
    base = os.path.join(root, "portbench")
    shutil.copy(os.path.join(base, "configs", "g32upc_d32st3.json"),
                os.path.join(base, "configs", "g32upc_d32st3_copy.json"))
    shutil.copy(os.path.join(base, "configs", "g32upc_d32st3.py"),
                os.path.join(base, "configs", "g32upc_d32st3_copy.py"))
    with open(os.path.join(base, "traffic", "train_b640_aug_f32.json")) as f:
        t = json.load(f)
    t["steps_per_epoch"] = 3
    with open(os.path.join(base, "traffic", "train_b8_new.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(base, "limits", "new.cell.json"), "w") as f:
        json.dump({k: TINY_LIMITS[k] for k in
                   ("loss", "grad1_d_median", "grad1_d_worst",
                    "grad1_g_median", "grad1_g_worst", "change3_median",
                    "change3_worst")}, f)
    with open(os.path.join(base, "metrics", "steps.new.py"), "w") as f:
        f.write("def read(res, cell):\n"
                "    return res.window.get('steps_per_epoch')\n")
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "g32upc_d32st3_copy", "source": "https://example.org",
        "file": "portbench/configs/g32upc_d32st3_copy.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({"name": "new.cell",
                               "config": "g32upc_d32st3_copy",
                               "traffic": "train_b8_new", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({
        "name": "steps.new", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "test",
        "moves": "train_images_per_s", "workloads": ["new.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_images_per_s":
            m["workloads"].append("new.cell")
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    after = _digest(root)
    assert all(after[k] == v for k, v in before.items())
    rc, line, err = run_cpu(root, "new.cell", trace=1)
    assert rc == 0 and line is not None, err[-3000:]
    assert line["metrics"]["steps.new"]["value"] == 3
    assert line["correct"] is True, err[-3000:]


FAULTS = [
    # a step that returns its state unchanged: no parameter is written
    ("train32.f32", "import catgen_torch.train.gan as g\n"
     "g._write = lambda params, values: None"),
    ("train64.f32", "import catgen_torch.train.gan as g\n"
     "g._write = lambda params, values: None"),
    # half of the batch left out, the mean taken over the rest
    ("train32.f32", "import catgen_torch.train.gan as g\n"
     "f = g.bce_logits\n"
     "g.bce_logits = lambda l, t: f(l[: l.shape[0] // 2], "
     "t[: t.shape[0] // 2])"),
    ("train64.f32", "import catgen_torch.train.gan as g\n"
     "f = g.bce_logits\n"
     "g.bce_logits = lambda l, t: f(l[: l.shape[0] // 2], "
     "t[: t.shape[0] // 2])"),
    # an answer altered where it is produced: the nearest neighbour
    ("sample32.nn100k", "import catgen_torch.sample.sampler as s\n"
     "f = s.nearest_neighbours\n"
     "def nn(q, c):\n"
     "    i, d = f(q, c)\n"
     "    return (i + 1) % c.shape[0], d\n"
     "s.nearest_neighbours = nn"),
    # and a D score altered
    ("sample32.nn100k", "import catgen_torch.train.gan as g\n"
     "f = g.discriminate\n"
     "g.discriminate = lambda d, x: f(d, x) * 0.999"),
]


@pytest.mark.parametrize("cell,prelude", FAULTS,
                         ids=[f"{c}-{i}" for i, (c, _) in enumerate(FAULTS)])
def test_a_broken_timed_path_is_not_correct(tiny, cell, prelude):
    rc, line, err = run_cpu(tiny, cell, prelude=prelude)
    assert rc == 0 and line is not None, err[-3000:]
    assert line["correct"] is False, err[-3000:]
