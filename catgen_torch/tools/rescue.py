"""Resume a collapsed GAN run from its last healthy checkpoint: the
counterpart of catgen's ``tools/rescue.py``, driving the port's
``catgen_torch.cli.train``.

A collapse is an event on a run's trajectory, not a property of its seed:
the run was typically healthy some epochs earlier. This tool

1. picks the newest checkpoint saved before the collapse
   (``adversarial.ckpt`` or its ``.old``; the collapse detector's abort
   writes the degenerate state to ``adversarial_collapsed.ckpt``), checked
   against ``collapse.json``'s ``fired_epoch`` and against the onset of the
   divergence in ``train_metrics.jsonl`` (``death_onset``);
2. resumes it under a new seed (original + 1000 + ``--seed-base`` + the
   attempt), with the run's recorded configuration and the detector on;
3. on another collapse retries with the next seed from the furthest
   healthy checkpoint any attempt reached.

    python -m catgen_torch.tools.rescue runs/sweep/ma0.95_s1 \\
        --to-epoch 750 --device cuda

``--device`` takes the place of catgen's ``--platform``. The attempts are
logged to ``<run>/rescue_result.json``; a completed attempt gets a report
(``catgen_torch.tools.report``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

from catgen_torch.eval.collapse import CollapseConfig
from catgen_torch.io.checkpoint import load_meta
from catgen_torch.tools import child_env, module_cmd


def _terminal_suffix_start(flags, min_tail):
    """First epoch of the unbroken degenerate suffix of ``flags``
    ([(epoch, bad)]), or None if the suffix is shorter than ``min_tail``
    (a single noisy final observation must not disqualify a healthy
    checkpoint)."""
    if not flags:
        return None
    tail = 0
    for _, bad in reversed(flags):
        if not bad:
            break
        tail += 1
    if tail < min_tail:
        return None
    return flags[len(flags) - tail][0]


def death_onset(run_dir, min_tail=3, min_viz_tail=2):
    """The largest checkpoint meta epoch that is still safe to resume,
    from the terminal degenerate stretch of ``train_metrics.jsonl``, or
    None if the recorded tail looks healthy.

    The detector's ``fired_epoch`` lags the divergence (it ignores
    everything before ``min_epoch`` and needs k consecutive hits), so a
    checkpoint can predate the firing and still hold a dead run. This
    scans the metrics for the divergence itself:

    * epoch records: loss_g >= ``loss_g_hi``, or loss_d >= 2 with
      acc_d <= 0.6;
    * visualization records (some collapses have no epoch-level
      signature): nn_l2_ratio >= ``nn_ratio_hi``, sample_sat above
      ``sat_threshold``, sample_std below ``std_floor``, or both probes
      pinned low.

    A visualization record at epoch O is logged before that epoch runs, so
    it describes the state a checkpoint with meta epoch O holds; an epoch
    record O describes the O-th completed epoch. Visualization onsets are
    moved down one, so that both mean "the largest safe meta epoch". The
    thresholds are ``CollapseConfig``'s, the detector's own."""
    cfg = CollapseConfig()
    path = os.path.join(run_dir, "train_metrics.jsonl")
    if not os.path.exists(path):
        return None
    epochs, vizzes = [], []
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("event") == "epoch" and "loss_d" in rec:
                bad = (rec.get("loss_g", 0.0) >= cfg.loss_g_hi
                       or (rec.get("loss_d", 0.0) >= 2.0
                           and rec.get("acc_d", 1.0) <= 0.6))
                epochs.append((rec["epoch"], bad))
            elif rec.get("event") == "viz":
                nn = rec.get("nn_l2_ratio")
                lo = 1 - cfg.probe_pin
                bad = ((nn is not None and nn >= cfg.nn_ratio_hi)
                       or rec.get("sample_sat", 0.0) > cfg.sat_threshold
                       or rec.get("sample_std", 1.0) < cfg.std_floor
                       or (rec.get("d_probe_pattern", 0.5) < lo
                           and rec.get("d_probe_real", 0.5) < lo))
                vizzes.append((rec["epoch"], bad))
    viz_onset = _terminal_suffix_start(vizzes, min_viz_tail)
    if viz_onset is not None:
        viz_onset -= 1
    onsets = [o for o in (_terminal_suffix_start(epochs, min_tail),
                          viz_onset)
              if o is not None]
    return min(onsets) if onsets else None


def pick_source(run_dir, explicit=None):
    """(path, meta) of the newest checkpoint that strictly predates the
    collapse: ``adversarial.ckpt``, else its ``.old``, each held against
    ``collapse.json``'s ``fired_epoch`` (a save at or after it is
    degenerate) and against ``death_onset`` (a meta epoch past the onset
    completed a degenerate epoch). Raises SystemExit if neither passes."""
    if explicit:
        return explicit, load_meta(explicit)
    ck = os.path.join(run_dir, "adversarial.ckpt")
    fired = None
    cj = os.path.join(run_dir, "collapse.json")
    if os.path.exists(cj):
        with open(cj) as f:
            fired = json.load(f).get("fired_epoch")
    onset = death_onset(run_dir)
    for cand in (ck, ck + ".old"):
        if os.path.exists(cand):
            meta = load_meta(cand)
            ep = meta.get("epoch", 0)  # next-epoch pointer: ep-1 done
            if fired is not None and ep >= fired:
                continue
            if onset is not None and ep > onset:
                continue
            return cand, meta
    raise SystemExit(
        f"[rescue] no pre-collapse checkpoint in {run_dir} "
        f"(detector fired at {fired}, metrics-level death onset at "
        f"{onset}; every snapshot post-dates the collapse). "
        f"Re-run with --saveFreq below the onset, or pass "
        f"--from explicitly.")


def train_cmd(meta, rescue_dir, network, seed, epochs_left, args):
    """The port's training command that continues the run of ``meta``
    (its harness and GAN configurations) from ``network``: every
    optimizer setting as trained, ``--dtype`` as given (not recorded)."""
    hc = meta.get("config", {})
    gc = meta.get("gan_config", {})
    cmd = module_cmd(
        "catgen_torch.cli.train",
        "--save", rescue_dir, "--network", network,
        "--seed", seed, "--epochs", epochs_left,
        "--collapseDetect",
        "--saveFreq", args.save_freq or hc.get("save_freq", 50),
        "--visFreq", hc.get("vis_freq", 5),
        "--scale", hc.get("scale", 32),
        "--colorSpace", hc.get("colorspace", "rgb"),
        "--noiseDim", hc.get("noise_dim", 100),
        "--N_epoch", hc.get("n_epoch", 1000),
        "--G", hc.get("g_model", "default"),
        "--D", hc.get("d_model", "default"),
        "--batchSize", gc.get("batch_size", 32),
        "--D_maxAcc", gc.get("d_max_acc", 1.01),
        "--D_iterations", gc.get("d_iterations", 1),
        "--G_iterations", gc.get("g_iterations", 1),
        "--D_optmethod", gc.get("d_optimizer", "adam"),
        "--G_optmethod", gc.get("g_optimizer", "adam"),
        "--D_sgd_lr", gc.get("d_sgd_lr", 0.02),
        "--G_sgd_lr", gc.get("g_sgd_lr", 0.02),
        "--D_sgd_momentum", gc.get("d_sgd_momentum", 0.0),
        "--G_sgd_momentum", gc.get("g_sgd_momentum", 0.0),
        "--D_L1", gc.get("d_l1", 0.0),
        "--D_L2", gc.get("d_l2", 1e-4),
        "--G_L1", gc.get("g_l1", 0.0),
        "--G_L2", gc.get("g_l2", 0.0),
        "--D_clamp", gc.get("d_clamp", 1.0),
        "--G_clamp", gc.get("g_clamp", 5.0),
        "--dtype", getattr(args, "dtype", "f32"),
        "--devices", hc.get("n_devices", 1),
        "--device", args.device)
    if getattr(args, "dataset", None):
        cmd += ["--dataset"] + list(args.dataset)
    if gc.get("augment"):
        cmd.append("--augment")
    if gc.get("g_frozen_children"):
        cmd += ["--G_freeze", ",".join(gc["g_frozen_children"])]
    if hc.get("normalize"):
        cmd.append("--normalize")
    return cmd


def _link_corpus_and_v(run_dir, rdir):
    """The original run's fixture corpus and V checkpoints, in the rescue
    directory."""
    fdst = os.path.join(rdir, "fixture")
    fsrc = os.path.join(run_dir, "fixture")
    if not os.path.isdir(fdst) and os.path.isdir(fsrc):
        try:
            os.symlink(os.path.abspath(fsrc), fdst)
        except OSError:
            shutil.copytree(fsrc, fdst)
    for f in os.listdir(run_dir):
        if f.startswith("v_") and f.endswith(".ckpt"):
            dst = os.path.join(rdir, f)
            if not os.path.exists(dst):
                shutil.copy(os.path.join(run_dir, f), dst)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dir")
    p.add_argument("--to-epoch", type=int, default=750,
                   help="target total epoch count")
    p.add_argument("--attempts", type=int, default=3,
                   help="max restart attempts (next seed each time)")
    p.add_argument("--seed-base", type=int, default=0,
                   help="first rescue seed = original + 1000 + this")
    p.add_argument("--from", dest="from_ckpt", default="",
                   help="explicit checkpoint to resume from")
    p.add_argument("--save-freq", type=int, default=25,
                   help="checkpoint cadence during the rescue")
    p.add_argument("--device", default="cuda",
                   help="torch device of the rescue run (cuda or cpu)")
    p.add_argument("--dataset", nargs="*", default=None,
                   help="image dirs for the rescue run (required when the "
                        "original run trained on --dataset: the corpus "
                        "path is not recorded in the checkpoint)")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="compute dtype of the rescue run (not recorded in "
                        "checkpoints; must match the original run)")
    args = p.parse_args(argv)

    run_dir = args.run_dir.rstrip("/")
    if not args.dataset and not os.path.isdir(
            os.path.join(run_dir, "fixture")):
        raise SystemExit(
            "[rescue] the original run has no fixture/ dir and no "
            "--dataset was given; pass --dataset <dirs> (the corpus path "
            "is not recorded in checkpoints)")
    src, meta = pick_source(run_dir, args.from_ckpt or None)
    base_seed = meta.get("config", {}).get("seed", 1)
    attempts_log = []

    for i in range(args.attempts):
        # meta "epoch" is the next-epoch pointer: E means E-1 completed
        completed = meta.get("epoch", 1) - 1
        left = args.to_epoch - completed
        if left <= 0:
            print(f"[rescue] source already has {completed} epochs >= "
                  f"{args.to_epoch}; nothing to do")
            break
        seed = base_seed + 1000 + args.seed_base + i
        rdir = os.path.join(run_dir, f"rescue_s{seed}")
        os.makedirs(rdir, exist_ok=True)
        _link_corpus_and_v(run_dir, rdir)

        cmd = train_cmd(meta, rdir, src, seed, left, args)
        print(f"[rescue] attempt {i + 1}/{args.attempts}: epoch {completed} "
              f"-> {args.to_epoch}, seed {seed}\n  {' '.join(cmd)}",
              flush=True)
        t0 = time.time()
        with open(os.path.join(rdir, "rescue.log"), "a") as log:
            rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=child_env()).returncode
        entry = {"attempt": i + 1, "seed": seed, "from_epoch": completed,
                 "source": src, "rc": rc,
                 "sec": round(time.time() - t0, 1)}
        if rc == 42:
            with open(os.path.join(rdir, "collapse.json")) as f:
                cj = json.load(f)
            entry.update(outcome="collapsed",
                         fired_epoch=cj.get("fired_epoch"),
                         reason=cj.get("reason"))
            # ratchet: the next attempt resumes from this attempt's newest
            # pre-collapse save if it got further
            try:
                src2, m2 = pick_source(rdir)
            except SystemExit:
                src2 = None
            if src2 is not None and \
                    m2.get("epoch", 0) > meta.get("epoch", 0):
                src, meta = src2, m2
                print(f"[rescue] ratchet: next attempt resumes from "
                      f"epoch {m2['epoch']}")
        elif rc == 0:
            entry["outcome"] = "completed"
        else:
            entry["outcome"] = f"error rc={rc}"
        attempts_log.append(entry)
        with open(os.path.join(run_dir, "rescue_result.json"), "w") as f:
            json.dump({"to_epoch": args.to_epoch,
                       "attempts": attempts_log}, f, indent=1)
        print(f"[rescue] attempt {i + 1}: {entry['outcome']}", flush=True)
        if rc == 0:
            subprocess.run(module_cmd("catgen_torch.tools.report", rdir),
                           env=child_env())
            print(f"[rescue] SUCCESS: healthy epoch-{args.to_epoch} run in "
                  f"{rdir}")
            return 0
        if rc != 42:
            break
    print("[rescue] no attempt reached the target epoch "
          f"(details: {os.path.join(run_dir, 'rescue_result.json')})")
    return 1


if __name__ == "__main__":
    sys.exit(main())
