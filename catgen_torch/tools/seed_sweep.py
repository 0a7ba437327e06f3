"""Seed sweep of the full workflow, with the collapse detector: the
counterpart of catgen's ``tools/seed_sweep.py``, on the port's CLIs.

Each configuration (D_maxAcc x seed) runs the reference recipe,
``catgen_torch.cli.train_v`` (once per corpus, shared) ->
``pretrain_g`` -> ``train --collapseDetect`` -> ``eval_quality``, in its
own directory, and a report beside it (``catgen_torch.tools.report``);
the outcomes go to ``<out>/sweep_results.json`` and a markdown table:

    python -m catgen_torch.tools.seed_sweep --out runs/sweep --epochs 750 \\
        --maxacc 1.01,0.95 --seeds 1,2,3 --fixture 1024 --device cuda

A re-run skips recorded configurations, except those whose stage timed
out (``--stage-timeout``: the stage is killed and recorded as
``rc=-1000``, and the sweep goes on). ``--rescue N`` gives each collapsed
configuration up to N restarts (``catgen_torch.tools.rescue``).
``--device`` takes the place of catgen's ``--platform``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

from catgen_torch.eval.collapse import scan_metrics
from catgen_torch.tools import child_env, module_cmd

TIMEOUT_RC = -1000  # sentinel: stage exceeded --stage-timeout


def run_cmd(args, log_path, timeout=None):
    """Runs ``args`` with its output appended to ``log_path``; its return
    code, or ``TIMEOUT_RC`` if it ran past ``timeout`` seconds (then it is
    killed)."""
    timeout = timeout or run_cmd.default_timeout
    with open(log_path, "a") as log:
        log.write("\n+ " + " ".join(args) + "\n")
        log.flush()
        try:
            p = subprocess.run(args, stdout=log, stderr=subprocess.STDOUT,
                               timeout=timeout, env=child_env())
        except subprocess.TimeoutExpired:
            log.write(f"\n[sweep] stage timed out after {timeout}s\n")
            return TIMEOUT_RC
    return p.returncode


run_cmd.default_timeout = 7200


def data_args(args):
    """The corpus flags of every stage: ``--dataset <dirs>`` wins over
    ``--fixture N``."""
    if getattr(args, "dataset", None):
        return ["--dataset"] + list(args.dataset)
    return ["--fixture", str(args.fixture)]


def ensure_v(out_root, args, v_epochs, log, device="cuda"):
    """The V checkpoint shared by every configuration on one corpus,
    trained once: (its directory, its path)."""
    tag = ("ds" if getattr(args, "dataset", None) else f"f{args.fixture}")
    vdir = os.path.join(out_root, f"_shared_v_{tag}")
    ck = os.path.join(vdir, "v_3x32x32.ckpt")
    if not os.path.exists(ck):
        os.makedirs(vdir, exist_ok=True)
        rc = run_cmd(module_cmd("catgen_torch.cli.train_v",
                                *data_args(args), "--epochs", v_epochs,
                                "--save", vdir, "--device", device), log)
        if rc != 0:
            raise RuntimeError(f"shared V training failed (rc={rc}), "
                               f"see {log}")
    return vdir, ck


def run_config(out_root, cfg, shared_vdir, v_ckpt, args):
    """One configuration's stages; its result record."""
    name = f"ma{cfg['maxacc']}_s{cfg['seed']}"
    rdir = os.path.join(out_root, name)
    os.makedirs(rdir, exist_ok=True)
    log = os.path.join(rdir, "run.log")
    result = {"name": name, **cfg,
              "corpus": (args.dataset if getattr(args, "dataset", None)
                         else f"fixture:{args.fixture}")}
    if getattr(args, "train_extra", ""):
        result["train_extra"] = args.train_extra

    fdir = os.path.join(rdir, "fixture")
    shared_fix = os.path.join(shared_vdir, "fixture")
    if not getattr(args, "dataset", None) and not os.path.isdir(fdir) \
            and os.path.isdir(shared_fix):
        shutil.copytree(shared_fix, fdir)
    shutil.copy(v_ckpt, os.path.join(rdir, os.path.basename(v_ckpt)))

    t0 = time.time()
    rc = run_cmd(module_cmd("catgen_torch.cli.pretrain_g", *data_args(args),
                            "--epochs", args.pretrain_epochs,
                            "--seed", cfg["seed"], "--save", rdir,
                            "--device", args.device), log)
    if rc != 0:
        result.update(outcome="error", stage="pretrain_g", rc=rc)
        return result

    train_args = [*data_args(args), "--epochs", args.epochs,
                  "--seed", cfg["seed"], "--D_maxAcc", cfg["maxacc"],
                  "--saveFreq", args.save_freq, "--visFreq", args.vis_freq,
                  "--collapseDetect", "--save", rdir,
                  "--device", args.device]
    if args.augment:
        train_args.append("--augment")
    train_args += (args.train_extra or "").split()
    rc = run_cmd(module_cmd("catgen_torch.cli.train", *train_args), log)
    result["train_sec"] = round(time.time() - t0, 1)
    run_cmd(module_cmd("catgen_torch.tools.report", rdir), log)

    if rc == 42:
        with open(os.path.join(rdir, "collapse.json")) as f:
            rep = json.load(f)
        result.update(outcome="collapsed", reason=rep["reason"],
                      fired_epoch=rep["fired_epoch"])
        return result
    if rc != 0:
        result.update(outcome="error", stage="train", rc=rc)
        return result

    # survived: the retro-scan (a false negative of the detector) and
    # the quality report
    retro = scan_metrics(os.path.join(rdir, "train_metrics.jsonl"))
    result["retro_scan"] = {k: retro[k] for k in ("collapsed", "reason")}
    rc = run_cmd(module_cmd("catgen_torch.cli.eval_quality",
                            *data_args(args), "--save", rdir,
                            "--device", args.device), log)
    if rc == 0:
        with open(os.path.join(rdir, "quality_report.json")) as f:
            q = json.load(f)
        result["quality"] = {
            "d_gen_mean": q["d_scores_generated"]["mean"],
            "d_real_mean": q["d_scores_real"]["mean"],
            "nn_l2_mean": q["nn_l2"]["mean"],
            "copy_fraction": q["nn_copy_fraction"],
            "per_pixel_std": q["diversity"]["mean_per_pixel_std"],
            "v_all": q.get("v_rating", {}).get("all"),
        }
    result["outcome"] = ("survived-but-degenerate"
                         if retro["collapsed"] else "completed")
    return result


def table(results):
    """The sweep's results as a markdown table."""
    rows = ["| run | D_maxAcc | seed | outcome | detail | train s |",
            "|---|---|---|---|---|---|"]
    for r in results:
        if r["outcome"] == "collapsed":
            detail = f"{r['reason']} @ep{r['fired_epoch']}"
            if r.get("rescued"):
                detail += " → rescued"
        elif r["outcome"] == "error":
            detail = f"{r['stage']} rc={r['rc']}"
        else:
            q = r.get("quality", {})
            detail = (f"std={q.get('per_pixel_std', 0):.3f} "
                      f"Dg={q.get('d_gen_mean', 0):.2f}")
        rows.append(f"| {r['name']} | {r['maxacc']} | {r['seed']} | "
                    f"{r['outcome']} | {detail} | "
                    f"{r.get('train_sec', '-')} |")
    return "\n".join(rows)


def _save(results, path):
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="runs/sweep")
    p.add_argument("--epochs", type=int, default=750)
    p.add_argument("--maxacc", default="1.01,0.95,0.9,0.8")
    p.add_argument("--seeds", default="1,2,3")
    p.add_argument("--fixture", type=int, default=1024)
    p.add_argument("--dataset", nargs="*", default=None,
                   help="JPEG corpus dirs; overrides --fixture in every "
                        "stage")
    p.add_argument("--v_epochs", type=int, default=30)
    p.add_argument("--pretrain_epochs", type=int, default=10)
    p.add_argument("--save_freq", type=int, default=50)
    p.add_argument("--vis_freq", type=int, default=5)
    # off by default, as the reference's train.lua has no train-time
    # augmentation (its corpus is augmented offline)
    p.add_argument("--augment", action="store_true", default=False)
    p.add_argument("--no-augment", dest="augment", action="store_false")
    p.add_argument("--device", default="cuda",
                   help="torch device of every stage (cuda or cpu)")
    p.add_argument("--train-extra", default="",
                   help="extra flags appended (whitespace-split) to every "
                        "train stage; kernel routes and alternates are "
                        "CATGEN_* environment variables of the sweep")
    p.add_argument("--rescue", type=int, default=0,
                   help="after the sweep, give each collapsed config up "
                        "to N restart attempts from its last healthy "
                        "checkpoint")
    p.add_argument("--stage-timeout", type=int, default=7200,
                   help="per-stage wall-clock limit in seconds; a stage "
                        "past it is killed and recorded as outcome=error "
                        "rc=-1000")
    args = p.parse_args(argv)
    run_cmd.default_timeout = args.stage_timeout

    os.makedirs(args.out, exist_ok=True)
    results_path = os.path.join(args.out, "sweep_results.json")
    results = []
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    # a stage timeout is transient: retry those configurations
    retry = {r["name"] for r in results
             if r.get("outcome") == "error" and r.get("rc") == TIMEOUT_RC}
    if retry:
        print(f"[sweep] retrying previously timed-out configs: "
              f"{sorted(retry)}")
        results = [r for r in results if r["name"] not in retry]
    done = {r["name"] for r in results}

    log = os.path.join(args.out, "sweep.log")
    vdir, v_ckpt = ensure_v(args.out, args, args.v_epochs, log, args.device)

    configs = [{"maxacc": ma, "seed": int(s)}
               for ma in args.maxacc.split(",")
               for s in args.seeds.split(",")]
    for cfg in configs:
        name = f"ma{cfg['maxacc']}_s{cfg['seed']}"
        if name in done:
            print(f"[sweep] {name}: already recorded, skipping")
            continue
        print(f"[sweep] {name}: running...", flush=True)
        r = run_config(args.out, cfg, vdir, v_ckpt, args)
        results.append(r)
        _save(results, results_path)
        print(f"[sweep] {name}: {r['outcome']} "
              f"({r.get('reason', '')} {r.get('train_sec', '')}s)",
              flush=True)

    if args.rescue > 0:
        for r in results:
            if r["outcome"] != "collapsed" or "rescue" in r:
                continue
            rdir = os.path.join(args.out, r["name"])
            print(f"[sweep] rescuing {r['name']}...", flush=True)
            rescue_cmd = module_cmd(
                "catgen_torch.tools.rescue", rdir, "--to-epoch", args.epochs,
                "--attempts", args.rescue, "--device", args.device)
            if getattr(args, "dataset", None):
                rescue_cmd += ["--dataset"] + list(args.dataset)
            rc = run_cmd(rescue_cmd, log)
            rres = os.path.join(rdir, "rescue_result.json")
            if os.path.exists(rres):
                with open(rres) as f:
                    r["rescue"] = json.load(f)
            else:
                r["rescue"] = {"rc": rc}
            r["rescued"] = rc == 0
            _save(results, results_path)
            print(f"[sweep] {r['name']}: rescue "
                  f"{'succeeded' if rc == 0 else 'failed'}", flush=True)

    print("\n" + table(results))
    n_ok = sum(r["outcome"] == "completed" for r in results)
    n_rescued = sum(r.get("rescued", False) for r in results)
    print(f"\n{n_ok}/{len(results)} runs completed healthy"
          + (f" (+{n_rescued} rescued to target)" if n_rescued else "")
          + f"; table + details in {results_path}")


if __name__ == "__main__":
    main()
