"""The collapse A/B table of several seed sweeps, in markdown: the
counterpart of catgen's ``tools/audit_table.py``. One row per sweep
directory (its ``sweep_results.json``, from ``seed_sweep``), one column per
seed: the epoch and reason the collapse detector fired at, a healthy or
degenerate survivor, or the stage that failed.

    python -m catgen_torch.tools.audit_table runs/sweepA runs/sweepB

``row_from_rescan`` classifies runs from their raw trajectories through
the port's detector instead (for sweeps recorded under an older detector
calibration).
"""

from __future__ import annotations

import json
import os
import sys

from catgen_torch.eval.collapse import scan_metrics

SEEDS = list(range(1, 7))


def row_from_results(path):
    """-> {seed: 'ep NNN (reason)' | 'healthy @N' | '...'} from a
    seed_sweep results file."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        results = json.load(f)
    for r in results:
        seed = r.get("seed")
        if r["outcome"] == "collapsed":
            cell = f"{r['fired_epoch']} ({r['reason'][:9]})"
            if r.get("rescued"):
                cell += " →rescued"
        elif r["outcome"] in ("completed", "survived-but-degenerate"):
            cell = ("**healthy 750**" if r["outcome"] == "completed"
                    else "degenerate@750")
        else:
            cell = f"err:{r.get('stage', '?')}"
        out[seed] = cell
    return out


def row_from_rescan(run_root, seeds):
    """{seed: cell} from each ``ma1.01_s<seed>/train_metrics.jsonl`` under
    ``run_root``, classified by ``scan_metrics``."""
    out = {}
    for s in seeds:
        p = os.path.join(run_root, f"ma1.01_s{s}", "train_metrics.jsonl")
        if not os.path.exists(p):
            continue
        rep = scan_metrics(p)
        with open(p) as f:
            n = sum(1 for line in f if '"event": "epoch"' in line)
        out[s] = (f"{rep['fired_epoch']} ({rep['reason'][:9]})"
                  if rep["collapsed"] else f"no fire thru {n}")
    return out


def table(arms, seeds=SEEDS) -> str:
    """The markdown table of ``arms``, (label, "results" or "rescan",
    path) each; an arm with no cell is left out."""
    lines = ["| arm | " + " | ".join(f"seed {s}" for s in seeds) + " |",
             "|---|" + "---|" * len(seeds)]
    for label, kind, path in arms:
        cells = (row_from_rescan(path, seeds) if kind == "rescan"
                 else row_from_results(path))
        if not cells:
            continue
        lines.append(f"| {label} | "
                     + " | ".join(str(cells.get(s, "—")) for s in seeds)
                     + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    dirs = sys.argv[1:] if argv is None else argv
    if not dirs:
        raise SystemExit("usage: python -m catgen_torch.tools.audit_table "
                         "SWEEP_DIR...")
    print(table([(os.path.basename(d.rstrip("/")), "results",
                  os.path.join(d, "sweep_results.json")) for d in dirs]))


if __name__ == "__main__":
    main()
