"""Runs sets of fresh-process runs of one cell on this machine and reports
each metric's spread as the benchmark's check reads it: the distance
between the first and the third quartile (``statistics.quantiles(n=4)``)
as a share of the median, per set with and without the run farthest from
the set's median, and over every run together.

    python3 portbench/sets.py --workload train32.f32 --seeds 11,12,13 \
        --sets 2 --seconds 40 [--trace 0] [--out chiprun_out/sets]

Each run is ``portbench/run.py`` in a process of its own; its result line
and the end of its standard error are kept under ``--out``. The runs of a
set take the seeds in order; every set takes the same seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med) if med else float("nan")


def spread_without_farthest(values):
    """The spread with the run farthest from the median left out, where
    that narrows it."""
    if len(values) < 3:
        return spread(values)
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    rest = values[:far] + values[far + 1:]
    return min(spread(values), spread(rest))


def one_run(workload, seed, seconds, trace, out_dir, tag):
    cmd = [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
           "--workload", workload, "--seed", str(seed), "--seconds",
           str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t
    with open(os.path.join(out_dir, f"{tag}.err"), "w") as f:
        f.write(p.stderr[-20000:])
    line = None
    if p.returncode == 0 and p.stdout.strip():
        line = json.loads(p.stdout.strip().splitlines()[-1])
        with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
            json.dump(line, f)
    return p.returncode, line, wall, p.stderr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "sets"))
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out_dir = os.path.join(args.out, args.workload)
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            tag = f"t{args.trace}_set{k}_seed{seed}"
            rc, line, wall, err = one_run(args.workload, seed, args.seconds,
                                          args.trace, out_dir, tag)
            runs.append((k, seed, rc, line))
            tail = [ln for ln in err.splitlines()
                    if ln.startswith(("set-up", "per-step", "request ms",
                                      "card at", "check", "window:",
                                      "reference"))]
            print(f"== {tag}: rc {rc}, {wall:.1f} s wall, correct "
                  f"{line and line['correct']}", flush=True)
            for ln in tail:
                print("   " + ln[:400], flush=True)
            if line:
                print("   metrics " + json.dumps(
                    {m: v["value"] for m, v in line["metrics"].items()}),
                    flush=True)
            if rc != 0:
                print(err[-3000:], flush=True)
    names = sorted({m for _, _, _, ln in runs if ln for m in ln["metrics"]})
    summary = {}
    for m in names:
        per_set = [[ln["metrics"][m]["value"] for k2, _, _, ln in runs
                    if ln and k2 == k and m in ln["metrics"]]
                   for k in range(args.sets)]
        every = [v for s in per_set for v in s]
        summary[m] = {
            "medians": [statistics.median(s) if s else None
                        for s in per_set],
            "spread": [spread(s) for s in per_set],
            "spread_drop1": [spread_without_farthest(s) for s in per_set],
            "spread_all": spread(every),
            "values": per_set,
        }
    print("SUMMARY " + json.dumps(summary), flush=True)
    with open(os.path.join(out_dir, f"summary_t{args.trace}.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    return 0 if all(rc == 0 for _, _, rc, _ in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
