"""Readings that the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own sizes (the benchmark's own runs never run this):

  * the program's readings on each of ``--seeds`` (the lower readings):
    training, the first three steps through the window's call and the
    reference over them; sampling, the requests a run would check;
  * the control's on each of ``--control-seeds``: the reference itself in
    the program's place, with TF32 on (the nearest precision below the
    f32 that the configuration states), judged against the reference
    with TF32 off;
  * for training, the planted faults on the same seeds: the loss's mean
    taken over half the batch (in the reference put in the program's
    place), and the step that leaves its state unchanged, which reads 1
    by the ``change3`` measure without a run;
  * for training, a witness on every seed: the reference in float64, read
    against the reference in f32 (how far f32 round-off alone moves each
    number) and against the program. Every leaf's norms of each side are
    written beside the summary.

    python3 portbench/control.py --workload train32.f32 \
        --seeds 1,2,...,12 --control-seeds 21,22,23

Prints one line per reading and a JSON summary (largest program reading,
smallest control and fault readings per number).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".")
                        not in (ROOT, os.path.join(ROOT, "portbench"))]

import torch  # noqa: E402

from portbench import cell as cells  # noqa: E402
from portbench import drive_sample as S  # noqa: E402
from portbench import drive_train as DT  # noqa: E402
from portbench import judge  # noqa: E402


SOUND = ("program", "witness")      # readings of sound runs: the largest


def train_readings(cell, seed, device, faults: bool, leaves=None):
    prog = DT.Program(cell, seed, device)
    records, _, u8, prog_side = DT.checked_steps(prog, cell, seed, device)
    specs = (prog.g_spec, prog.d_spec)
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    ref_side = DT.reference_side(cell, seed, specs, records, u8, device)
    out = {"program": judge.train_numbers(prog_side, ref_side)}
    f64 = DT.reference_side(cell, seed, specs, records, u8, device,
                            dtype=torch.float64)
    out["witness_f32_vs_f64"] = judge.train_numbers(ref_side, f64)
    out["witness_program_vs_f64"] = judge.train_numbers(prog_side[:3], f64)
    if leaves is not None:
        leaves[seed] = {who: {"loss": side[0], "grad1": side[1],
                              "change3": side[2]}
                        for who, side in (("program", prog_side),
                                          ("reference", ref_side),
                                          ("f64", f64))}
        leaves[seed]["program"]["epoch_loss"] = prog_side[3]
    print(f"  seed {seed} losses (D, G a step): program "
          f"{[round(v, 7) for v in prog_side[0]]} reference "
          f"{[round(v, 7) for v in ref_side[0]]}; leaves with a zero "
          f"reference gradient: "
          f"{sorted(k for k, v in ref_side[1].items() if v == 0)[:8]}",
          flush=True)
    if faults:
        tf32 = DT.reference_side(cell, seed, specs, records, u8, device,
                                 tf32=True)
        out["control_tf32"] = judge.train_numbers(tf32, ref_side)
        half = DT.reference_side(cell, seed, specs, records, u8, device,
                                 loss_rows="half")
        out["fault_half_batch"] = judge.train_numbers(half, ref_side)
        print(f"  seed {seed} losses: control {[round(v, 7) for v in tf32[0]]}"
              f" half batch {[round(v, 7) for v in half[0]]}", flush=True)
    return out


def sample_readings(cell, seed, device, control: bool):
    prog = S.Program(cell, seed, device)
    corpus = S.make_corpus(cell, seed, device)
    gen = torch.Generator(device=device)
    kept = {}
    for i in S.checked_indices(seed):
        gen.manual_seed(S.request_seed(seed, i))
        result, nn = S.request(prog, cell, gen, corpus, device)
        kept[i] = S.answer_of(result, nn, cell.traffic["n_best"])
    torch.cuda.synchronize()
    specs = (prog.g_spec, prog.d_spec)
    del prog
    out = {"program": (S.reference_numbers(cell, seed, specs, kept, corpus,
                                           device), {})}
    if control:
        out["control_tf32"] = (S.reference_numbers(
            cell, seed, specs, kept, corpus, device, tf32=True), {})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "control"))
    args = ap.parse_args(argv)
    cell = cells.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from catgen_torch.cli.common import resolve_device
    from catgen_torch.kernels.build import load_library

    device = resolve_device("cuda:0")
    load_library()
    kind = cell.traffic["kind"]
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = [int(s) for s in args.control_seeds.split(",")]
    table = []
    leaves: dict = {}
    for seed in seeds + [s for s in controls if s not in seeds]:
        t = time.perf_counter()
        extra = seed in controls
        try:
            r = (train_readings(cell, seed, device, extra, leaves)
                 if kind == "train"
                 else sample_readings(cell, seed, device, extra))
        except Exception:           # a reading that fails is reported
            import traceback
            traceback.print_exc()
            continue
        for who, (nums, worst) in r.items():
            table.append({"seed": seed, "who": who, **nums, **{
                k: v for k, v in worst.items() if isinstance(v, float)}})
            print(f"{args.workload} seed {seed} {who}: "
                  + " ".join(f"{k} {v!r}" for k, v in nums.items())
                  + (f" worst {worst}" if worst else "")
                  + f" ({time.perf_counter() - t:.1f} s)", flush=True)
    summary = {}
    for who in sorted({row["who"] for row in table}):
        rows = [row for row in table if row["who"] == who]
        keys = [k for k in rows[0] if k not in ("seed", "who")]
        pick = max if who.startswith(SOUND) else min
        summary[who] = {k: pick(row[k] for row in rows) for k in keys}
        summary[who]["seeds"] = len(rows)
    print("SUMMARY " + json.dumps(summary), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}.json"), "w") as f:
        json.dump({"table": table, "summary": summary, "leaves": leaves},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
