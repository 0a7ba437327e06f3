"""A copy of the benchmark at sizes a CPU test run can hold: the same
files, with each traffic mix cut to a few rows and steps and the
harness's settings shortened, run through ``run.main`` on the CPU (which
skips the look for a card)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {
    "train": {"batch_size": 4, "steps_per_epoch": 3},
    "sample": {"count": 16, "top": 8, "n_best": 4, "corpus": 64},
}
# the harness's settings in the tiny runs, set before each run
HARNESS = ("from portbench import drive_train as _t, drive_sample as _s\n"
           "_t.REAL_POOL_EPOCHS = 2; _t.WARMUP_SECONDS = 0.0\n"
           "_t.WARMUP_STEPS_PER_CALL = 1; _t.TRACE_STEPS = 2\n"
           "_t.FORWARD_PROFILE_REPS = 1\n"
           "_s.WARMUP_SECONDS = 0.0; _s.TRACE_REQUESTS = 2\n"
           "_s.CHECKED_REQUESTS = 2; _s.CHECKED_FROM = 3\n")


def tiny_copy(dest: str) -> str:
    """The benchmark's files under ``dest``, traffic cut to TINY."""
    os.makedirs(dest, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("_runs", "_cache",
                                                  "__pycache__", "tests"))
    tdir = os.path.join(dest, "portbench", "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        with open(path) as f:
            t = json.load(f)
        t.update(TINY[t["kind"]])
        with open(path, "w") as f:
            json.dump(t, f)
    return dest


def run_cpu(root: str, workload: str, seed: int = 7, trace: int = 0,
            seconds: float = 0.3, env=None, prelude: str = ""):
    """Runs one cell of the copy at ``root`` on the CPU in a subprocess:
    (exit code, the result line or None, standard error). ``prelude`` is
    Python run after ``HARNESS`` (a fault planted in the program)."""
    code = (f"import sys; sys.path.insert(0, {root!r});\n{HARNESS}"
            f"{prelude}\n"
            f"from portbench import run\n"
            f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
            f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
            f"device='cpu', root={root!r}))")
    e = dict(os.environ)
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    e.update(env or {})
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=e,
                       capture_output=True, text=True, timeout=900)
    line = None
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        line = json.loads(lines[-1])
    return p.returncode, line, p.stderr
