"""``torch.profiler`` traces of a window, read into what the per-layer
metrics need: the device's busy time, kernels by name, each kernel's
launch on the host (to attribute it to the benchmark's own spans), the
longest idle gaps and what the host was doing in them.

The profiler's trace is written as Chrome-trace JSON into the run's own
directory, read back and deleted. Times in the file are microseconds;
everything here is seconds.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SPAN_PREFIX = "portbench."


class Trace:
    """One traced region."""

    def __init__(self, events: List[dict]):
        self.device: List[Tuple[float, float, str, str]] = []  # s, e, name, cat
        self.launch_of: Dict[int, float] = {}   # correlation -> launch time
        self.kernel_corr: List[Optional[int]] = []
        self.host: List[Tuple[float, float, str, int]] = []     # s, e, name, tid
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts = float(ev.get("ts", 0.0)) * 1e-6
            te = ts + float(ev.get("dur", 0.0)) * 1e-6
            name = str(ev.get("name", ""))
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append((ts, te, name, cat))
                self.kernel_corr.append(args.get("correlation"))
            elif cat in HOST_CATS:
                if cat in LAUNCH_CATS and "correlation" in args:
                    self.launch_of[args["correlation"]] = ts
                self.host.append((ts, te, name, ev.get("tid", 0)))
                if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
                    self.spans.setdefault(name, []).append((ts, te))
        order = sorted(range(len(self.device)), key=lambda i: self.device[i][0])
        self.device = [self.device[i] for i in order]
        self.kernel_corr = [self.kernel_corr[i] for i in order]
        for v in self.spans.values():
            v.sort()

    # -- the window ------------------------------------------------------

    def window(self, span: str) -> Tuple[float, float]:
        """First start and last end of the span ``span``."""
        s = self.spans.get(span)
        if not s:
            raise KeyError(f"no span {span!r} in the trace")
        return s[0][0], max(e for _, e in s)

    def busy_intervals(self, lo: float, hi: float) -> List[Tuple[float, float]]:
        """The union of device activity inside [lo, hi]."""
        out: List[List[float]] = []
        for s, e, _, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    def busy_seconds(self, lo: float, hi: float) -> float:
        return sum(b - a for a, b in self.busy_intervals(lo, hi))

    def device_ops(self, lo: float, hi: float, top: int = 10):
        """[name, seconds] of the device operations that took most time,
        summed by full name, named short (``short_name``)."""
        tot: Dict[str, float] = {}
        for s, e, name, _ in self.device:
            if lo <= s < hi:
                tot[name] = tot.get(name, 0.0) + (e - s)
        return sorted(([short_name(k), v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, lo: float, hi: float, top: int = 10):
        """[what the host was doing, seconds] of the longest idle gaps: the
        innermost host event open when the device went idle."""
        busy = self.busy_intervals(lo, hi)
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        if busy:
            gaps = [(lo, busy[0][0])] + gaps + [(busy[-1][1], hi)]
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:top]
        out = []
        for a, b in gaps:
            t = a + 1e-7
            open_ = [h for h in self.host if h[0] <= t <= h[1]
                     and not h[2].startswith(SPAN_PREFIX + "window")]
            name = min(open_, key=lambda h: h[1] - h[0])[2] if open_ \
                else "host idle"
            out.append([name, b - a])
        return out

    # -- kernels inside the benchmark's spans -----------------------------

    def kernels_in_span(self, span: str):
        """(name, seconds) of each device operation launched inside any
        interval of the span ``span``."""
        ivs = self.spans.get(span, [])
        starts = [s for s, _ in ivs]
        out = []
        for (s, e, name, _), corr in zip(self.device, self.kernel_corr):
            t = self.launch_of.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ivs[i][1]:
                out.append((name, e - s))
        return out

    def device_seconds_in_span(self, span: str) -> float:
        return sum(d for _, d in self.kernels_in_span(span))


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without ``void``, ``at::native::`` and its argument
    list, at most ``width`` characters."""
    name = name.replace("at::native::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):      # the first '(' outside template <>
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:width]


@contextlib.contextmanager
def profiled(device, run_dir: str, tag: str, out: dict):
    """Profiles the block (host and, on a card, CUDA activity) and puts
    its ``Trace`` in ``out[tag]``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"trace_{tag}.json")
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    out[tag] = Trace(data.get("traceEvents", []) if isinstance(data, dict)
                     else data)


def span(name: str):
    """A span of the benchmark's own, seen by the profiler when it runs."""
    return torch.profiler.record_function(SPAN_PREFIX + name)
