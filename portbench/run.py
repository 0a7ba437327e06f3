"""The port's benchmark: runs one cell of ``BENCHMARK.json`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Without a CUDA card, or with fewer cards
than the cell asks for, it exits 2 and prints no result. It makes its
inputs and weights from ``--seed``, sets up and warms up the cell's own
shapes, measures for ``--seconds`` (``--trace 0``: the cell's end-to-end
metrics; ``--trace 1``: also a traced window, and its per-layer metrics),
then checks what the timed path produced against the plain reference
(``portbench/reference``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and with ``--trace 1`` ``breakdown``), then ``checks``, each compared
number beside its limit; the same numbers are the last lines of standard
error, after the run's notes (per-step or per-request quartiles, the
card's clocks, power and temperature at the window's start and end, the
set-up's parts). It exits 3, with no result, if JAX, flax or catgen (the
JAX package) is loaded in this process once the window has closed.

Caches: the program builds its CUDA library into ``catgen_torch/_build``
inside the checkout; Triton's, PyTorch's extension and inductor caches are
pointed at ``portbench/_cache`` and traces are written, read and deleted
in ``portbench/_runs``, all at fixed paths inside the checkout.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "catgen")

for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = os.path.join(CACHE, _sub)
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ["USE_FLAX"] = "0"
# the checkout's root, not this folder, is where imports start: a file
# here must not shadow a module of the standard library
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".")
                        not in (ROOT, os.path.join(ROOT, "portbench"))]


class HostInfo:
    """The card's name, power limit, SM clock, power draw and temperature
    from ``nvidia-smi``."""

    FIELDS = "name,power.limit,clocks.sm,power.draw,temperature.gpu"

    def __init__(self, index: int = 0):
        self.index = index

    def smi_line(self) -> str:
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--query-gpu={self.FIELDS}",
                 "--format=csv,noheader", "-i", str(self.index)],
                capture_output=True, text=True, timeout=20)
            return out.stdout.strip() or out.stderr.strip()
        except (OSError, subprocess.SubprocessError) as e:
            return f"nvidia-smi unavailable ({e})"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, root: str = ROOT,
         manifest: str = "BENCHMARK.json") -> int:
    """Runs the cell. ``device`` is given only by the benchmark's own CPU
    tests, which skip the look for a card."""
    args = parse(argv)
    from portbench import cell as cells
    from portbench.result import Result

    cell = cells.load_cell(root, args.workload, manifest)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.set_num_threads(1)
    device = torch.device(device)
    # the CLIs' f32 mode: TF32 off, cuDNN deterministic, no autotuning
    from catgen_torch.cli.common import resolve_device
    resolve_device(str(device))

    seed = args.seed % (1 << 63)
    res = Result()
    hostinfo = HostInfo()
    kind = cell.traffic["kind"]
    driver = importlib.import_module(f"portbench.drive_{kind}")
    driver.run(cell, seed, args.seconds, bool(args.trace), device, res,
               T_START, hostinfo, os.path.join(root, "portbench", "_runs"))

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"forbidden modules loaded in the benchmark's process: "
              f"{found}", file=sys.stderr)
        return 3

    if args.trace:
        metrics = cells.read_per_layer(cell, res)
    else:
        metrics = {m["name"]: {"value": float(res.e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in res.e2e}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type ==
                    "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": int(res.memory_peak_bytes)}
    if args.trace:
        dev["busy_s"] = res.busy_s
        dev["window_s"] = res.window_s
    line = {"correct": res.correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": dev}
    if args.trace and res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, v, lim in res.checks}

    err = sys.stderr
    print(f"cell {cell.name}: seed {args.seed}, {args.seconds} s, trace "
          f"{args.trace}, route: {_route()}", file=err)
    print("set-up parts (s): " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in res.setup.items()), file=err)
    for n in res.notes:
        print(n, file=err)
    for k, v in metrics.items():
        print(f"metric {k} {v['value']!r} {v['unit']}", file=err)
    for k, v, lim in res.checks:
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILS'}", file=err)
    err.flush()
    print(json.dumps(line), flush=True)
    return 0


def _route() -> str:
    from catgen_torch.kernels import config
    return (f"upsample {config.resolve_upsample_impl()}, sampler "
            f"{config.resolve_sampler_impl()}/{config.sampler_kernel}, "
            f"st_conv {config.resolve_st_conv_impl()}, joint_loc "
            f"{config.joint_loc}")


if __name__ == "__main__":
    sys.exit(main())
