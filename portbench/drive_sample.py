"""Traffic of kind ``sample``: the ``sample.lua`` pipeline as a closed loop
of one client. Each request generates ``count`` images from uniform noise
(``sample_and_rank``: G in eval mode, ranked by D), then searches the best
``n_best`` against the corpus (``neighbours_of_best``), and ends in a
synchronize. Request i draws from a generator seeded from ``--seed`` and
i. The corpus is made on the device from the seed.

The window is closed on the first request end at or after ``--seconds``;
the rate is every sample generated, ranked and searched over all the
time of the window, the tail the 95th percentile of every request's
latency. ``CHECKED_REQUESTS`` requests drawn from the seed among the
first ``CHECKED_FROM`` are kept and judged against the plain reference
once the window has closed.

The harness's own settings are the constants below; a traffic mix holds
only what describes the traffic.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from portbench import counts as C
from portbench import judge
from portbench import tracing as T
from portbench import weights as W
from portbench.result import Result, quartiles

WARMUP_SECONDS = 2.0        # warm-up by time, at least two requests
TRACE_REQUESTS = 10         # the traced requests
CHECKED_REQUESTS = 8        # requests judged against the reference
CHECKED_FROM = 100          # drawn among the window's first requests
# the served model's weights: catgen's init times 4, a D whose scores a
# lower precision moves; at catgen's own init the TF32 control's scores and
# ranking read as close to the reference as the program's (PERF.md)
SERVE_GAIN = 4.0


class Program:
    def __init__(self, cell, seed: int, device):
        from catgen_torch import models

        cfg = cell.config
        image = tuple(cfg["image"])
        self.g = models.G_REGISTRY[cfg["g"]](image, cfg["noise_dim"]).to(device)
        self.d = models.D_REGISTRY[cfg["d"]](image).to(device)
        self.g_spec, self.d_spec = W.spec_of(self.g), W.spec_of(self.d)
        W.load_into(self.g, W.make(self.g_spec, seed, "g", device,
                                   SERVE_GAIN))
        W.load_into(self.d, W.make(self.d_spec, seed, "d", device,
                                   SERVE_GAIN))


def make_corpus(cell, seed: int, device) -> torch.Tensor:
    h, w, c = cell.config["image"]
    gen = W.cuda_generator(seed, "corpus", device)
    return torch.rand((cell.traffic["corpus"], h, w, c), generator=gen,
                      device=device)


def request(prog: Program, cell, gen: torch.Generator, corpus, device):
    """One request of the pipeline, as ``sample.py`` makes it."""
    from catgen_torch.sample import sampler

    tr = cell.traffic
    result = sampler.sample_and_rank(
        prog.g, prog.d, gen, noise_dim=cell.config["noise_dim"],
        count=tr["count"], top=tr["top"], device=device)
    nn = sampler.neighbours_of_best(result, corpus, tr["n_best"])
    return result, nn


def request_seed(seed: int, i: int) -> int:
    return W.subseed(seed, f"request{i}")


def checked_indices(seed: int):
    rng = np.random.default_rng(W.subseed(seed, "checked"))
    return sorted(rng.choice(CHECKED_FROM, CHECKED_REQUESTS,
                             replace=False).tolist())


def reference_numbers(cell, seed: int, specs, kept, corpus, device,
                      tf32: bool = False):
    """Each kept request judged: the program's answers (or, with
    ``tf32``, the reference's own in TF32, the control) against the plain
    reference in f32 with TF32 off."""
    ref, tr, cfg = cell.reference, cell.traffic, cell.config
    g_spec, d_spec = specs
    gw = W.make(g_spec, seed, "g", device, SERVE_GAIN)
    dw = W.make(d_spec, seed, "d", device, SERVE_GAIN)
    worst = {}
    for i, ans in kept.items():
        gen = torch.Generator(device=device)
        gen.manual_seed(request_seed(seed, i))
        noise = torch.rand((tr["count"], cfg["noise_dim"]), generator=gen,
                           device=device) * 2.0 - 1.0
        with torch.no_grad():
            ref_images = _blocks(lambda z: ref.g_forward(gw, z, False), noise)
            if tf32:
                ans = control_answer(cell, gw, dw, noise, corpus)
            logits = _blocks(lambda x: ref.d_forward(dw, x), ans["images"])
            ref_scores = torch.sigmoid(logits[:, 0])
        nums = judge.sample_numbers(ans["images"], ans["scores"],
                                    ans["picks"], ans["nn_idx"],
                                    ans["nn_dist"], ref_images, ref_scores,
                                    corpus)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def _blocks(fn, x, block: int = 256):
    return torch.cat([fn(x[i:i + block]) for i in range(0, x.shape[0],
                                                         block)])


def control_answer(cell, gw, dw, noise, corpus) -> dict:
    """The reference in the program's place in TF32: images, scores, the
    best n and their nearest neighbours by the expanded distance."""
    ref, tr = cell.reference, cell.traffic
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        images = _blocks(lambda z: ref.g_forward(gw, z, False), noise)
        scores = torch.sigmoid(_blocks(lambda x: ref.d_forward(dw, x),
                                       images)[:, 0])
        picks = torch.argsort(-scores, stable=True)[:tr["n_best"]]
        q = images[picks].reshape(len(picks), -1)
        c = corpus.reshape(corpus.shape[0], -1)
        d2 = ((q * q).sum(1)[:, None] + (c * c).sum(1)[None, :]
              - 2.0 * q @ c.T).clamp_min(0.0)
        idx = d2.argmin(1)
        dist = d2.gather(1, idx[:, None])[:, 0].sqrt()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return {"images": images, "scores": scores, "picks": picks,
            "nn_idx": idx, "nn_dist": dist}


def answer_of(result, nn, n_best: int) -> dict:
    return {"images": result["images"], "scores": result["scores"],
            "picks": result["order"][:n_best], "nn_idx": nn["indices"],
            "nn_dist": nn["distances"]}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, device,
        res: Result, t_start: float, hostinfo, run_dir: str) -> None:
    tr = cell.traffic
    cuda = device.type == "cuda"
    t = time.perf_counter()
    res.setup["start_s"] = t - t_start
    if cuda:
        from catgen_torch.kernels.build import load_library
        load_library()
    res.setup["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prog = Program(cell, seed, device)
    corpus = make_corpus(cell, seed, device)
    sync(device)
    res.setup["models_corpus_s"] = time.perf_counter() - t
    t = time.perf_counter()
    gen = torch.Generator(device=device)
    warm = 0
    while True:
        gen.manual_seed(W.subseed(seed, f"warmup{warm}"))
        request(prog, cell, gen, corpus, device)
        sync(device)
        warm += 1
        if warm >= 2 and time.perf_counter() - t >= WARMUP_SECONDS:
            break
    res.setup["warmup_s"] = time.perf_counter() - t
    res.setup["warmup_requests"] = warm

    keep = set(checked_indices(seed))
    kept = {}
    if cuda:
        res.note(f"card at window start: {hostinfo.smi_line()}")
    gc.collect()
    gc.freeze()
    lat, disp = [], []
    i = 0
    t0 = time.perf_counter()
    res.e2e["setup_s"] = t0 - t_start
    while True:
        gen.manual_seed(request_seed(seed, i))
        ta = time.perf_counter()
        result, nn = request(prog, cell, gen, corpus, device)
        tb = time.perf_counter()
        sync(device)
        tc = time.perf_counter()
        lat.append(tc - ta)
        disp.append(tb - ta)
        if i in keep:
            kept[i] = answer_of(result, nn, tr["n_best"])
        i += 1
        if tc - t0 >= seconds:
            break
    window_s = tc - t0
    gc.unfreeze()
    if cuda:
        res.note(f"card at window end: {hostinfo.smi_line()}")
    res.spans["request"] = lat
    res.spans["dispatch"] = disp
    res.window.update(seconds=window_s, requests=i,
                      images=i * tr["count"])
    res.e2e["sample_images_per_s"] = i * tr["count"] / window_s
    res.e2e["sample_ms_p95"] = 1000.0 * statistics.quantiles(
        lat, n=20, method="inclusive")[18] if len(lat) > 1 else lat[0] * 1e3
    res.attempted, res.failed = i, 0
    q = quartiles([x * 1e3 for x in lat])
    res.note(f"request ms ({i} requests): q1 {q[0]:.3f} median {q[1]:.3f} "
             f"q3 {q[2]:.3f}; dispatch median "
             f"{1e3 * statistics.median(disp):.3f}")
    res.memory_peak_bytes = (torch.cuda.max_memory_allocated() if cuda
                             else 0)

    if trace:
        _trace(cell, prog, seed, corpus, device, res, run_dir)

    specs = (prog.g_spec, prog.d_spec)
    del prog, result, nn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    missing = keep - set(kept)
    if missing:
        res.note(f"checked requests never served in the window: "
                 f"{sorted(missing)}")
    t = time.perf_counter()
    numbers = reference_numbers(cell, seed, specs, kept, corpus, device)
    res.note(f"reference: {time.perf_counter() - t:.2f} s over "
             f"{len(kept)} requests")
    for k in ("img", "score", "rank", "nn"):
        res.checks.append((k, numbers.get(k, float("nan")),
                           cell.limits[k]))


def _trace(cell, prog: Program, seed: int, corpus, device, res: Result,
           run_dir: str) -> None:
    """``TRACE_REQUESTS`` requests under the profiler, each in the
    benchmark's spans (``request``, and ``nn`` around the search)."""
    from catgen_torch.sample import sampler

    tr = cell.traffic
    gen = torch.Generator(device=device)
    n = TRACE_REQUESTS
    with T.profiled(device, run_dir, "requests", res.traces):
        with T.span("window"):
            for i in range(n):
                gen.manual_seed(W.subseed(seed, f"trace{i}"))
                with T.span("request"):
                    result = sampler.sample_and_rank(
                        prog.g, prog.d, gen,
                        noise_dim=cell.config["noise_dim"],
                        count=tr["count"], top=tr["top"], device=device)
                    with T.span("nn"):
                        sampler.neighbours_of_best(result, corpus,
                                                   tr["n_best"])
                    sync(device)
    tt = res.traces["requests"]
    lo, hi = tt.window("portbench.window")
    res.busy_s, res.window_s = tt.busy_seconds(lo, hi), hi - lo
    res.window["trace_requests"] = n
    res.breakdown = {"device_ops": tt.device_ops(lo, hi),
                     "idle_gaps": tt.idle_gaps(lo, hi)}


def request_macs(cell) -> int:
    """Counted MACs of one request: G and D forward on ``count`` images and
    the search of the best ``n_best`` against the corpus."""
    ref, tr, cfg = cell.reference, cell.traffic, cell.config
    n = tr["count"]
    dim = int(np.prod(cfg["image"]))
    return (C.forward_macs(ref.g_ops(n)) + C.forward_macs(ref.d_ops(n))
            + C.nn_search(tr["n_best"], tr["corpus"], dim).macs)
