"""The port's run tools (``catgen_torch/tools``) against catgen's
(``tools/*.py``) on the same inputs: the slim checkpoint, the rescue's
death onset, checkpoint choice and training command, the seed sweep's
table and stage timeout, the HTML report and the audit table; and a tiny
port run on the CPU that is slimmed and resumed with ``--rebuildOptstate``,
and rescued end to end through the port's CLI.

catgen's tools are loaded from their files, as its own tests load them.
The outputs are compared exactly: the tools compute no floating-point
values of their own. ``build_report`` reads no clock, so the two reports
are compared byte for byte with nothing masked.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

from catgen_torch.cli import train as train_cli
from catgen_torch.io import checkpoint as tckpt
from catgen_torch.tools import audit_table, report, rescue, seed_sweep
from catgen_torch.tools import child_env, slim_ckpt

from test_report import _write_run
from test_rescue import _write_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _catgen_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"catgen_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A port run on the CPU: 16px fixture, G16up against D16b, two epochs
    of two steps, a checkpoint after each (``adversarial.ckpt`` holds
    meta epoch 3, its ``.old`` 2)."""
    save = str(tmp_path_factory.mktemp("tiny") / "run")
    train_cli.main(["--device", "cpu", "--fixture", "8", "--scale", "16",
                    "--G", "g16up", "--D", "d16b", "--batchSize", "8",
                    "--N_epoch", "16", "--epochs", "2", "--saveFreq", "1",
                    "--visFreq", "10", "--save", save])
    return save


# ---------------------------------------------------------------------------
# slim_ckpt
# ---------------------------------------------------------------------------

# keys past the optimizer prefixes without a key boundary: catgen's slim
# strips them, the port's keeps them
BOUNDARY = (".g_optimizer_note['x']", ".options['y']", ".d_opt_extra")


def _checkpoint(path):
    rng = np.random.RandomState(0)
    leaves = {k: rng.rand(3, 2).astype(np.float32) for k in (
        ".g_params['00_Dense']['kernel']", ".d_params['00_Conv']['bias']",
        ".g_state['01_BatchNorm']['mean']", ".g_opt.m['00_Dense']['kernel']",
        ".g_opt.step", ".d_opt.v['00_Conv']['bias']", ".opt.step",
        ".d_opt", *BOUNDARY)}
    tckpt.save(path, leaves, {"epoch": 7})
    return leaves


def test_slim_keeps_catgens_leaves_but_for_the_boundary_cases(tmp_path):
    src = str(tmp_path / "a.ckpt")
    leaves = _checkpoint(src)
    catgen = _catgen_tool("slim_ckpt")
    got = slim_ckpt.slim(src, str(tmp_path / "port.ckpt"))
    want = catgen.slim(src, str(tmp_path / "catgen.ckpt"))
    with np.load(str(tmp_path / "port.ckpt")) as zp, \
            np.load(str(tmp_path / "catgen.ckpt")) as zc:
        port_keys, catgen_keys = set(zp.files), set(zc.files)
        assert port_keys == catgen_keys | set(BOUNDARY)
        for k in catgen_keys - {"__meta__"}:
            assert np.array_equal(zp[k], zc[k]), k
        for k in BOUNDARY:
            assert np.array_equal(zp[k], leaves[k]), k
    assert (got["kept"], got["dropped"]) == (6, 5)
    assert (want["kept"], want["dropped"]) == (3, 8)
    assert tckpt.load_meta(str(tmp_path / "port.ckpt")) == \
        tckpt.load_meta(str(tmp_path / "catgen.ckpt")) == {
            "epoch": 7, "format_version": tckpt.FORMAT_VERSION,
            "slim": True}


def test_slim_failed_write_leaves_dst_untouched(tmp_path):
    src, dst = str(tmp_path / "a.ckpt"), str(tmp_path / "slim.ckpt")
    _checkpoint(src)
    with open(dst, "wb") as f:
        f.write(b"the previous file")
    with mock.patch.object(slim_ckpt.os, "replace",
                           side_effect=OSError("disk full")):
        with pytest.raises(OSError, match="disk full"):
            slim_ckpt.slim(src, dst)
    with open(dst, "rb") as f:
        assert f.read() == b"the previous file"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    slim_ckpt.main([src, dst])
    assert tckpt.load_meta(dst)["slim"] is True


def test_slimmed_port_checkpoint_resumes_with_rebuild_optstate(
        tiny_run, tmp_path):
    slim = str(tmp_path / "slim.ckpt")
    r = slim_ckpt.slim(os.path.join(tiny_run, "adversarial.ckpt"), slim)
    assert r["dropped"] > 0
    with np.load(slim) as z:
        assert not [k for k in z.files if k.startswith((".g_opt", ".d_opt"))]
        kept = {k: z[k] for k in z.files if k.startswith(".g_params")}
    args = ["--device", "cpu", "--scale", "16", "--G", "g16up", "--D",
            "d16b", "--batchSize", "8", "--N_epoch", "16", "--epochs", "1",
            "--visFreq", "10", "--dataset", os.path.join(tiny_run, "fixture"),
            "--network", slim]
    with pytest.raises(KeyError, match="opt"):
        train_cli.main(args + ["--save", str(tmp_path / "strict")])
    loaded = {}
    real_load = tckpt.load_like

    def spy(path, template, lenient=()):
        out = real_load(path, template, lenient)
        loaded.update(out[0])
        return out

    with mock.patch.object(tckpt, "load_like", spy):
        harness = train_cli.main(args + ["--rebuildOptstate", "--save",
                                         str(tmp_path / "resumed")])
    for k, v in kept.items():
        assert np.array_equal(loaded[k], v), k
    assert tckpt.load_meta(str(tmp_path / "resumed" / "adversarial.ckpt"))[
        "epoch"] == 4
    assert harness.state.step == 12           # 4 steps an epoch


# ---------------------------------------------------------------------------
# rescue
# ---------------------------------------------------------------------------


def _onset_cases(tmp_path):
    """tests/test_rescue.py's metrics trajectories: (name, run dir)."""
    cases = []

    def run(name):
        d = tmp_path / name
        d.mkdir()
        cases.append((name, str(d)))
        return d

    _write_metrics(str(run("divergence") / "train_metrics.jsonl"),
                   [(e, 0.5, 2.0, 0.8) for e in range(1, 29)]
                   + [(e, 8.0, 15.0, 0.5) for e in range(29, 71)])
    _write_metrics(str(run("healthy") / "train_metrics.jsonl"),
                   [(e, 0.5, 2.0, 0.8) for e in range(1, 50)])
    _write_metrics(str(run("noisy_end") / "train_metrics.jsonl"),
                   [(e, 0.5, 2.0, 0.8) for e in range(1, 49)]
                   + [(49, 9.0, 15.0, 0.5)])
    run("no_metrics")
    for name, last in (("viz_far", 146), ("viz_one_bad", 100)):
        with open(run(name) / "train_metrics.jsonl", "w") as f:
            for e in range(1, last):
                f.write(json.dumps({"event": "epoch", "epoch": e,
                                    "loss_d": 0.70, "loss_g": 0.7,
                                    "acc_d": 0.55}) + "\n")
                if e % 5 == 0:
                    nn = (1.55 if e >= 135 else 1.25) if name == "viz_far" \
                        else (1.55 if e == 95 else 1.25)
                    f.write(json.dumps({
                        "event": "viz", "epoch": e, "d_probe_pattern": 0.46,
                        "d_probe_real": 0.50, "sample_sat": 0.04,
                        "sample_std": 0.12, "nn_l2_ratio": nn}) + "\n")
            f.write("not json\n")
    return cases


def test_death_onset_gives_catgens_answers(tmp_path):
    catgen = _catgen_tool("rescue")
    answers = {}
    for name, d in _onset_cases(tmp_path):
        answers[name] = rescue.death_onset(d)
        assert answers[name] == catgen.death_onset(d), name
    assert answers == {"divergence": 29, "healthy": None, "noisy_end": None,
                       "no_metrics": None, "viz_far": 134,
                       "viz_one_bad": None}


@pytest.mark.parametrize("fired,rows,want", [
    (4, None, "adversarial.ckpt"),          # the rotation save predates it
    (3, None, "adversarial.ckpt.old"),      # it was saved at the firing
    (70, [(1, 0.5, 2.0, 0.8)] + [(e, 8.0, 15.0, 0.5) for e in (2, 3, 4)],
     "adversarial.ckpt.old"),               # it postdates the death
    (2, None, None),                        # every save postdates it
])
def test_pick_source_gives_catgens_answers(tmp_path, fired, rows, want):
    catgen = _catgen_tool("rescue")
    run = tmp_path / "run"
    run.mkdir()
    for epoch in (2, 3):             # the first save becomes the .old
        tckpt.save(str(run / "adversarial.ckpt"), {".epoch": np.int32(0)},
                   {"epoch": epoch})
    assert tckpt.load_meta(str(run / "adversarial.ckpt.old"))["epoch"] == 2
    with open(run / "collapse.json", "w") as f:
        json.dump({"collapsed": True, "reason": "saturated",
                   "fired_epoch": fired}, f)
    if rows:
        _write_metrics(str(run / "train_metrics.jsonl"), rows)
    if want is None:
        for tool in (rescue, catgen):
            with pytest.raises(SystemExit, match="no pre-collapse"):
                tool.pick_source(str(run))
        return
    got, want_catgen = rescue.pick_source(str(run)), \
        catgen.pick_source(str(run))
    assert got == want_catgen
    assert got[0] == str(run / want)


def test_train_cmd_maps_catgens_flags_to_the_port():
    catgen = _catgen_tool("rescue")
    meta = {"epoch": 650,
            "config": {"save_freq": 50, "vis_freq": 5, "scale": 16,
                       "colorspace": "yuv", "noise_dim": 100,
                       "n_epoch": 1000, "g_model": "g16up",
                       "d_model": "d16_st3", "seed": 1, "n_devices": 2,
                       "normalize": True},
            "gan_config": {"batch_size": 32, "d_max_acc": 0.95,
                           "d_iterations": 2, "g_iterations": 1,
                           "d_optimizer": "sgd", "d_sgd_momentum": 0.5,
                           "d_l2": 1e-3, "g_clamp": 2.0, "augment": True,
                           "g_frozen_children": ["00_Dense", "02_PReLU"]}}
    args = type("A", (), {"save_freq": 25, "device": "cpu",
                          "platform": "cpu", "dtype": "bf16",
                          "dataset": ["/data/a", "/data/b"]})()
    got = rescue.train_cmd(meta, "/r", "/src.ckpt", 1001, 100, args)
    want = catgen.train_cmd(meta, "/r", "/src.ckpt", 1001, 100, args)
    assert got[:3] == [sys.executable, "-m", "catgen_torch.cli.train"]
    assert want[:3] == [sys.executable, "-m", "catgen.cli.train"]
    i = want.index("--platform")
    assert got[3:] == want[3:i] + ["--device", "cpu"] + want[i + 2:]
    parsed = train_cli.parse_args(got[3:])      # every flag is the CLI's
    assert (parsed.device, parsed.dtype, parsed.G_freeze, parsed.devices) \
        == ("cpu", "bf16", "00_Dense,02_PReLU", 2)
    assert parsed.dataset == ["/data/a", "/data/b"] and parsed.normalize


def test_rescue_end_to_end_resumes_the_port_run(tiny_run, tmp_path):
    save = str(tmp_path / "run")
    subprocess.run(["cp", "-r", tiny_run, save], check=True)
    ck = os.path.join(save, "adversarial.ckpt")
    subprocess.run(["cp", ck, os.path.join(
        save, "adversarial_collapsed.ckpt")], check=True)
    with open(os.path.join(save, "collapse.json"), "w") as f:
        json.dump({"collapsed": True, "reason": "saturated",
                   "fired_epoch": 4}, f)
    proc = subprocess.run(
        [sys.executable, "-m", "catgen_torch.tools.rescue", save,
         "--to-epoch", "3", "--attempts", "1", "--device", "cpu"],
        cwd=str(tmp_path), env=child_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(os.path.join(save, "rescue_result.json")) as f:
        res = json.load(f)
    assert res["attempts"][0]["outcome"] == "completed"
    assert res["attempts"][0]["source"] == ck
    rdir = os.path.join(save, "rescue_s1001")
    meta = tckpt.load_meta(os.path.join(rdir, "adversarial.ckpt"))
    # the source had 2 epochs done (meta 3); --to-epoch 3 -> 1 more
    assert meta["epoch"] == 4 and meta["config"]["seed"] == 1001
    assert meta["config"]["collapse_detect"] is True
    assert os.path.exists(os.path.join(rdir, "report.html"))


# ---------------------------------------------------------------------------
# seed_sweep
# ---------------------------------------------------------------------------

SWEEP_RESULTS = [
    {"name": "ma0.9_s1", "maxacc": "0.9", "seed": 1, "outcome": "collapsed",
     "reason": "d_runaway", "fired_epoch": 120, "train_sec": 200.0},
    {"name": "ma0.9_s2", "maxacc": "0.9", "seed": 2, "outcome": "collapsed",
     "reason": "saturated", "fired_epoch": 80, "rescued": True},
    {"name": "ma0.9_s3", "maxacc": "0.9", "seed": 3, "outcome": "completed",
     "train_sec": 900.0,
     "quality": {"per_pixel_std": 0.16, "d_gen_mean": 0.33}},
    {"name": "ma0.8_s1", "maxacc": "0.8", "seed": 1, "outcome": "error",
     "stage": "train", "rc": 1},
    {"name": "ma0.8_s2", "maxacc": "0.8", "seed": 2,
     "outcome": "survived-but-degenerate", "train_sec": 12.5},
    {"name": "ma0.8_s4", "maxacc": "0.8", "seed": 4, "outcome": "error",
     "stage": "pretrain_g", "rc": seed_sweep.TIMEOUT_RC},
]


def test_sweep_table_is_catgens():
    catgen = _catgen_tool("seed_sweep")
    assert seed_sweep.table(SWEEP_RESULTS) == catgen.table(SWEEP_RESULTS)
    assert "d_runaway @ep120" in seed_sweep.table(SWEEP_RESULTS)


def test_sweep_stage_timeout_is_recorded_as_catgens(tmp_path):
    catgen = _catgen_tool("seed_sweep")
    assert seed_sweep.TIMEOUT_RC == catgen.TIMEOUT_RC
    slow = [sys.executable, "-c", "import time; time.sleep(30)"]
    logs = {}
    for name, tool in (("port", seed_sweep), ("catgen", catgen)):
        logs[name] = str(tmp_path / f"{name}.log")
        assert tool.run_cmd(slow, logs[name], timeout=1) == \
            seed_sweep.TIMEOUT_RC
    with open(logs["port"]) as fp, open(logs["catgen"]) as fc:
        text = fp.read()
        assert text == fc.read()
    assert "stage timed out after 1s" in text
    assert seed_sweep.run_cmd([sys.executable, "-c", "print('ok')"],
                              logs["port"], timeout=30) == 0


def test_sweep_stages_are_the_port_clis(tmp_path):
    args = type("A", (), {"fixture": 16, "dataset": None, "device": "cpu",
                          "pretrain_epochs": 1, "epochs": 1, "save_freq": 1,
                          "vis_freq": 1, "augment": True, "train_extra": ""})()
    calls = []

    def fake_run(cmd, log, timeout=None):
        calls.append(cmd)
        if cmd[2] == "catgen_torch.cli.train":
            with open(os.path.join(cmd[cmd.index("--save") + 1],
                                   "collapse.json"), "w") as f:
                json.dump({"reason": "saturated", "fired_epoch": 9}, f)
            return 42
        return 0

    vdir = tmp_path / "v"
    vdir.mkdir()
    (vdir / "v_3x32x32.ckpt").write_bytes(b"v")
    with mock.patch.object(seed_sweep, "run_cmd", fake_run):
        r = seed_sweep.run_config(str(tmp_path), {"maxacc": "0.9",
                                                  "seed": 2},
                                  str(vdir), str(vdir / "v_3x32x32.ckpt"),
                                  args)
    assert [c[2] for c in calls] == ["catgen_torch.cli.pretrain_g",
                                     "catgen_torch.cli.train",
                                     "catgen_torch.tools.report"]
    assert all(c[c.index("--device") + 1] == "cpu" for c in calls[:2])
    assert r["outcome"] == "collapsed" and r["fired_epoch"] == 9


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("collapsed", [False, True])
def test_report_html_is_byte_equal_to_catgens(tmp_path, collapsed):
    catgen = _catgen_tool("report")
    d = str(tmp_path / "run")
    _write_run(d, collapsed=collapsed)
    with open(os.path.join(d, "quality_report.json"), "w") as f:
        json.dump({"d_scores_generated": {"mean": 0.3,
                                          "percentiles": {"50": 0.29}},
                   "d_scores_real": {"mean": 0.7,
                                     "percentiles": {"50": 0.75}},
                   "d_fooled_fraction": 0.16,
                   "nn_l2": {"mean": 5.5,
                             "percentiles": {"5": 4.0, "95": 7.4}},
                   "nn_copy_fraction": 0.0,
                   "diversity": {"mean_pairwise_l2": 12.8,
                                 "mean_per_pixel_std": 0.162}}, f)
    got = report.build_report(d)
    assert got == catgen.build_report(d)
    assert ("collapse detected" in got) == collapsed
    out = str(tmp_path / "r.html")
    report.main([d, "-o", out])
    with open(out) as f:
        assert f.read() == got


def test_report_watch_rerenders_on_change(tmp_path):
    d = str(tmp_path / "run")
    _write_run(d, epochs=10)
    out = str(tmp_path / "live.html")
    with contextlib.redirect_stdout(io.StringIO()):
        assert report.watch(d, out, interval=0, max_renders=1) == 1
    with open(out) as f:
        first = f.read()
    assert "http-equiv='refresh'" in first
    sig = report._run_signature(d)
    assert report._run_signature(d) == sig
    with open(os.path.join(d, "train_metrics.jsonl"), "a") as f:
        f.write(json.dumps({"event": "epoch", "epoch": 11, "loss_d": 0.5,
                            "loss_g": 1.0, "acc_d": 0.8,
                            "d_trained_frac": 1.0,
                            "imgs_per_sec": 1500.0}) + "\n")
    assert report._run_signature(d) != sig
    with contextlib.redirect_stdout(io.StringIO()):
        assert report.watch(d, out, interval=0, max_renders=1) == 1
    with open(out) as f:
        second = f.read()
    assert second != first and "11 epochs" in second
    assert second == _catgen_tool("report").build_report(d, refresh=1)


# ---------------------------------------------------------------------------
# audit_table
# ---------------------------------------------------------------------------


def test_audit_table_is_catgens(tmp_path, monkeypatch, capsys):
    catgen = _catgen_tool("audit_table")
    dirs = []
    for name, results in (("armA", SWEEP_RESULTS[:3]),
                          ("armB", SWEEP_RESULTS[3:]), ("empty", [])):
        d = tmp_path / name
        d.mkdir()
        if results:
            with open(d / "sweep_results.json", "w") as f:
                json.dump(results, f)
        dirs.append(str(d))
    monkeypatch.setattr(sys, "argv", ["audit_table.py"] + dirs)
    catgen.main()
    want = capsys.readouterr().out
    audit_table.main(dirs)
    got = capsys.readouterr().out
    assert got == want
    assert "| armA | 120 (d_runaway) | 80 (saturated) →rescued |" in got
    # the rescan of raw trajectories through the detector
    run = tmp_path / "sweep" / "ma1.01_s2"
    run.mkdir(parents=True)
    _write_metrics(str(run / "train_metrics.jsonl"),
                   [(e, 0.5, 2.0, 0.8) for e in range(1, 40)])
    assert audit_table.row_from_rescan(str(tmp_path / "sweep"), [1, 2]) == \
        catgen.row_from_rescan(str(tmp_path / "sweep"), [1, 2]) == {
            2: "no fire thru 39"}


def test_shell_wrappers_parse_and_name_the_port():
    for name in ("longrun.sh", "collect_longrun_artifacts.sh"):
        path = os.path.join(ROOT, "catgen_torch", "tools", name)
        assert subprocess.run(["bash", "-n", path]).returncode == 0, name
        with open(path) as f:
            text = f.read()
        assert "catgen_torch." in text and "--device" in text
        assert "catgen.cli" not in text and "python tools/" not in text
