"""Traffic of kind ``train``: the program's GAN training epochs, driven as
``GanHarness.run_epoch`` drives them, on reals made from the seed.

Each epoch is one host-to-device copy of the epoch's uint8 reals (made
ahead, before the window), their conversion to [0, 1] floats on the
device, the program's epoch function over ``steps_per_epoch`` steps, and
one fetch of the epoch's metrics. The window holds whole epochs: it
starts on an epoch boundary and closes on the first boundary at or after
``--seconds``. Its rate is every image trained (2 B a step: D on B, G on
B) over all the time of the window.

Set-up: build the program's kernels, make both models' weights on the
device from the seed, make the reals, run one full-length epoch call from
the initial state (its first three steps' losses are kept for the
check), return the same state to the initial weights, run the first
three steps again through the window's own call and feed (their state is
kept for the check and goes on into the window), then warm up by time on
the same call. The check runs the plain reference over those three steps
once the window has closed.

The harness's own settings are the constants below; a traffic mix holds
only what describes the traffic.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import counts as C
from portbench import draws as D
from portbench import judge
from portbench import tracing as T
from portbench import weights as W
from portbench.reference import gan as refgan
from portbench.result import Result, quartiles

BETA1 = 0.9     # the configuration's Adam (Torch7's defaults)
CHECK_STEPS = 3             # the steps the reference follows
REAL_POOL_EPOCHS = 4        # epochs of reals made before the window
WARMUP_SECONDS = 2.0        # warm-up by time, at least this long
WARMUP_SETTLE = 0.02        # two calls in a row agree within this share
WARMUP_STEPS_PER_CALL = 5
TRACE_STEPS = 10            # the traced epoch's steps
FORWARD_PROFILE_REPS = 3    # G and D forwards profiled from outside


class Program:
    """The program's models, train state and epoch function, with the
    weights and the specs they were made from."""

    def __init__(self, cell, seed: int, device):
        from catgen_torch import models
        from catgen_torch.train import gan

        cfg, tr = cell.config, cell.traffic
        image = tuple(cfg["image"])
        self.g = models.G_REGISTRY[cfg["g"]](image, cfg["noise_dim"]).to(device)
        self.d = models.D_REGISTRY[cfg["d"]](image).to(device)
        self.g_spec, self.d_spec = W.spec_of(self.g), W.spec_of(self.d)
        self.g0 = W.make(self.g_spec, seed, "g", device)
        self.d0 = W.make(self.d_spec, seed, "d", device)
        W.load_into(self.g, self.g0)
        W.load_into(self.d, self.d0)
        self.config = gan.GanConfig(
            batch_size=tr["batch_size"], noise_dim=cfg["noise_dim"],
            acc_window=tr["acc_window"], augment=tr["augment"],
            compute_dtype=getattr(torch, tr["dtype"]))
        self.state = gan.init_state(self.g, self.d, self.config)
        self.epoch_fn = gan.make_train_epoch(self.g, self.d, self.config)


def feed(u8: np.ndarray, device) -> torch.Tensor:
    """The loader's feed: one host-to-device copy, then [0, 1] floats."""
    return torch.from_numpy(u8).to(device).float() / 255.0


def fetch(m) -> List[float]:
    """One device-to-host fetch of the epoch's metrics, as the harness's."""
    return torch.stack([m.loss_d.mean(), m.loss_g.mean(), m.acc_d.mean(),
                        m.d_trained.mean()]).tolist()


def real_shape(cell, steps: int):
    h, w, c = cell.config["image"]
    return (steps, cell.traffic["batch_size"] // 2, h, w, c)


def checked_steps(prog: Program, cell, seed: int, device):
    """The first three steps, on rows that all differ, twice from the
    initial state: once inside one full-length epoch call (its losses),
    then, the state reset, through the window's own call and feed as one
    step and two (the first gradient, the change after three, the
    losses), whose state goes on into the window. Both take the same
    draws. Returns the draws the second took, the draws a step takes, the
    reals and the program's side of the comparison."""
    from catgen_torch.core.random import Draws
    from catgen_torch.train import gan

    n = CHECK_STEPS
    nb = cell.traffic["steps_per_epoch"]
    if nb < n:
        raise ValueError(f"an epoch of {nb} steps holds fewer than the "
                         f"{n} checked steps")
    u8 = W.uint8_images(seed, "check", real_shape(cell, nb))
    full = prog.epoch_fn(prog.state, feed(u8, device),
                         Draws(W.cuda_generator(seed, "check", device)))
    epoch_losses = torch.stack([full.loss_d[:n], full.loss_g[:n]],
                               1).reshape(-1).tolist()
    del full
    W.load_into(prog.g, prog.g0)
    W.load_into(prog.d, prog.d0)
    prog.state = gan.init_state(prog.g, prog.d, prog.config)

    records: List[D.Record] = []
    draws = D.recording(Draws, W.cuda_generator(seed, "check", device),
                        records)
    m1 = prog.epoch_fn(prog.state, feed(u8[:1], device), draws)
    per_step = len(records)
    grads = (judge.leaf_norms(prog.state.g_opt.m, "g", 1.0 / (1.0 - BETA1))
             | judge.leaf_norms(prog.state.d_opt.m, "d", 1.0 / (1.0 - BETA1)))
    m2 = prog.epoch_fn(prog.state, feed(u8[1:n], device), draws)
    change = (judge.leaf_norms(_delta(prog.g, prog.g0), "g")
              | judge.leaf_norms(_delta(prog.d, prog.d0), "d"))
    losses = [v for m in (m1, m2) for v in torch.stack(
        [m.loss_d, m.loss_g], 1).reshape(-1).tolist()]
    return records, per_step, u8[:n], (losses, grads, change, epoch_losses)


def _delta(module, w0) -> Dict[str, torch.Tensor]:
    return {k: p.detach() - w0[k] for k, p in module.named_parameters()}


def reference_side(cell, seed: int, specs, records, u8, device,
                   tf32: bool = False, loss_rows: str = "all",
                   dtype: torch.dtype = torch.float32):
    """The plain reference's three steps from the same weights, reals and
    draws: (losses, first-gradient norms, change norms). ``tf32`` and
    ``loss_rows`` are the control and a planted fault, ``dtype`` float64
    the witness of the limits' readings: never a measured run's."""
    ref, tr = cell.reference, cell.traffic
    g_spec, d_spec = specs
    g0 = {k: v.to(dtype) for k, v in W.make(g_spec, seed, "g",
                                            device).items()
          if not k.endswith((".mean", ".var"))}
    d0 = {k: v.to(dtype) for k, v in W.make(d_spec, seed, "d",
                                            device).items()
          if not k.endswith((".mean", ".var"))}
    cfg = refgan.StepConfig(batch_size=tr["batch_size"],
                            noise_dim=cell.config["noise_dim"],
                            augment=tr["augment"],
                            acc_window=tr["acc_window"], loss_rows=loss_rows)
    trainer = refgan.Trainer(cfg, g0, d0, ref.g_forward, ref.d_forward)
    replay = D.Replay(records, device, dtype)
    reals = torch.from_numpy(np.ascontiguousarray(u8)).to(device, dtype) \
        / 255.0
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        grads = None
        for i in range(reals.shape[0]):
            trainer.step(reals[i], replay)
            if i == 0:
                grads = (judge.leaf_norms(trainer.g_adam.m, "g",
                                          1.0 / (1.0 - cfg.beta1))
                         | judge.leaf_norms(trainer.d_adam.m, "d",
                                            1.0 / (1.0 - cfg.beta1)))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    if not replay.done():
        raise RuntimeError(f"the reference drew {replay.at} of the "
                           f"program's {len(replay.records)} draws")
    change = (judge.leaf_norms({k: trainer.g[k] - g0[k] for k in g0}, "g")
              | judge.leaf_norms({k: trainer.d[k] - d0[k] for k in d0}, "d"))
    losses = [v for pair in trainer.losses for v in pair]
    return losses, grads, change


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, device,
        res: Result, t_start: float, hostinfo, run_dir: str) -> None:
    from catgen_torch.core.random import Draws
    from catgen_torch.kernels.build import load_library

    tr = cell.traffic
    b = tr["batch_size"]
    nb = tr["steps_per_epoch"]
    cuda = device.type == "cuda"
    t = time.perf_counter()
    res.setup["start_s"] = t - t_start
    if cuda:
        load_library()
    res.setup["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prog = Program(cell, seed, device)
    sync(device)
    res.setup["models_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pool = [W.uint8_images(seed, f"epoch{i}", real_shape(cell, nb))
            for i in range(REAL_POOL_EPOCHS)]
    res.setup["reals_s"] = time.perf_counter() - t
    t = time.perf_counter()
    records, per_step, check_u8, prog_side = checked_steps(
        prog, cell, seed, device)
    res.setup["checked_steps_s"] = time.perf_counter() - t

    # warm-up by time on the window's call (the checked full-length call
    # has fed a whole epoch once): short calls until WARMUP_SECONDS have
    # passed and two calls in a row agree on the step's time within
    # WARMUP_SETTLE (at most three times WARMUP_SECONDS)
    t = time.perf_counter()
    gen = W.cuda_generator(seed, "warmup", device)
    warm_steps = 0
    prev = None
    while True:
        chunk = pool[warm_steps // nb % len(pool)][:WARMUP_STEPS_PER_CALL]
        tc = time.perf_counter()
        fetch(prog.epoch_fn(prog.state, feed(chunk, device), Draws(gen)))
        step_s = (time.perf_counter() - tc) / len(chunk)
        warm_steps += len(chunk)
        settled = prev is not None and abs(step_s - prev) <= (
            WARMUP_SETTLE * prev)
        prev = step_s
        spent = time.perf_counter() - t
        if (spent >= WARMUP_SECONDS and settled) or (
                spent >= 3 * WARMUP_SECONDS):
            break
    res.setup["warmup_s"] = time.perf_counter() - t
    res.setup["warmup_steps"] = warm_steps

    # the window
    if cuda:
        res.note(f"card at window start: {hostinfo.smi_line()}")
    gc.collect()
    gc.freeze()
    events: List[torch.cuda.Event] = []
    ends: List[int] = []
    steps = epochs = 0
    t0 = time.perf_counter()
    res.e2e["setup_s"] = t0 - t_start
    while True:
        ta = time.perf_counter()
        x = feed(pool[epochs % len(pool)], device)
        tb = time.perf_counter()
        gen = W.cuda_generator(seed, f"window{epochs}", device)
        m = prog.epoch_fn(prog.state, x, D.clocked(
            Draws, gen, per_step, events) if cuda else Draws(gen))
        tc = time.perf_counter()
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events.append(end)
            ends.append(len(events) - 1)
        fetch(m)
        td = time.perf_counter()
        res.span("data", tb - ta)
        res.span("dispatch", tc - tb)
        res.span("fetch", td - tc)
        steps += nb
        epochs += 1
        if td - t0 >= seconds:
            break
    window_s = td - t0
    gc.unfreeze()
    if cuda:
        res.note(f"card at window end: {hostinfo.smi_line()}")
    res.window.update(seconds=window_s, steps=steps, epochs=epochs,
                      images=2 * b * steps, steps_per_epoch=nb)
    res.e2e["train_images_per_s"] = 2 * b * steps / window_s
    res.attempted, res.failed = steps, 0
    step_ms = []
    start = 0
    for e in ends:
        step_ms += [events[i].elapsed_time(events[i + 1])
                    for i in range(start, e)]
        start = e + 1
    res.window["step_ms"] = step_ms
    if step_ms:
        q = quartiles(step_ms)
        res.note(f"per-step wall ms (device events, {len(step_ms)} steps):"
                 f" q1 {q[0]:.3f} median {q[1]:.3f} q3 {q[2]:.3f}")
    res.note(f"window: {epochs} epochs, {steps} steps, {window_s:.4f} s; "
             f"per epoch data/dispatch/fetch s: "
             + "; ".join(f"{a:.4f}/{b_:.4f}/{c:.4f}" for a, b_, c in zip(
                 res.spans["data"], res.spans["dispatch"],
                 res.spans["fetch"])))
    res.memory_peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0

    if trace:
        _trace(cell, prog, seed, device, res, run_dir)

    # the check: the program's state is freed, the reference runs after
    specs = (prog.g_spec, prog.d_spec)
    del prog, m, x
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref_side = reference_side(cell, seed, specs, records, check_u8, device)
    numbers, worst = judge.train_numbers(prog_side, ref_side)
    res.note(f"reference: {time.perf_counter() - t:.2f} s; worst: {worst}")
    for k, v in numbers.items():
        res.checks.append((k, v, cell.limits[k]))


def _trace(cell, prog: Program, seed: int, device, res: Result,
           run_dir: str) -> None:
    """A traced epoch of ``TRACE_STEPS`` steps on the window's call, then
    one G and one D forward at the step's batch, each profiled from
    outside the step (G's BatchNorm statistics restored after)."""
    from catgen_torch.core.random import Draws
    from catgen_torch.kernels.upsample_conv import UpsampleConv
    from catgen_torch.nn.layers import set_draws

    tr = cell.traffic
    n = TRACE_STEPS
    u8 = W.uint8_images(seed, "trace", real_shape(cell, n))
    gen = W.cuda_generator(seed, "trace", device)
    with T.profiled(device, run_dir, "epoch", res.traces):
        with T.span("window"):
            with T.span("data"):
                x = feed(u8, device)
            with T.span("dispatch"):
                m = prog.epoch_fn(prog.state, x, Draws(gen))
            with T.span("fetch"):
                fetch(m)
    tt = res.traces["epoch"]
    lo, hi = tt.window("portbench.window")
    res.busy_s, res.window_s = tt.busy_seconds(lo, hi), hi - lo
    res.window["trace_steps"] = n
    res.breakdown = {"device_ops": tt.device_ops(lo, hi),
                     "idle_gaps": tt.idle_gaps(lo, hi)}

    b = tr["batch_size"]
    g, d = prog.g, prog.d
    saved = [t.clone() for t in g.buffers()]
    stack: list = []

    def enter(mod, inp):
        rf = torch.profiler.record_function(T.SPAN_PREFIX + "upconv")
        rf.__enter__()
        stack.append(rf)

    def leave(mod, inp, out):
        stack.pop().__exit__(None, None, None)

    hooks = []
    for mod in g.modules():
        if isinstance(mod, UpsampleConv):
            hooks += [mod.register_forward_pre_hook(enter),
                      mod.register_forward_hook(leave)]
    noise = torch.rand((b, cell.config["noise_dim"]), generator=gen,
                       device=device) * 2.0 - 1.0
    reps = FORWARD_PROFILE_REPS
    try:
        g.train()
        with torch.no_grad():
            g(noise)
            with T.profiled(device, run_dir, "g_fwd", res.traces):
                for _ in range(reps):
                    with T.span("g_fwd"):
                        g(noise)
    finally:
        for h in hooks:
            h.remove()
        with torch.no_grad():
            for t, s in zip(g.buffers(), saved):
                t.copy_(s)
    h, w, c = cell.config["image"]
    imgs = torch.rand((b, h, w, c), generator=gen, device=device)
    d.train()
    set_draws(d, Draws(gen))
    with torch.no_grad():
        d(imgs)
        with T.profiled(device, run_dir, "d_fwd", res.traces):
            for _ in range(reps):
                with T.span("d_fwd"):
                    d(imgs)
    res.window["forward_profile_reps"] = reps


def step_macs(cell) -> int:
    """Counted MACs of one training step of the cell."""
    ref, b = cell.reference, cell.traffic["batch_size"]
    return C.gan_step_macs(ref.g_ops(b // 2), ref.g_ops(b), ref.d_ops(b))


def upconv_least_seconds(cell) -> float:
    ref, b = cell.reference, cell.traffic["batch_size"]
    dt = cell.traffic["dtype"]
    return sum(C.least_seconds(op.macs, op.bytes, dt)
               for op in ref.g_ops(b) if op.kind == "upconv")


def sampler_least_seconds_per_step(cell) -> Dict[str, tuple]:
    """Per sampler pass (forward, dcoords, dimg): the launches a step
    makes and their least seconds."""
    ref, b = cell.reference, cell.traffic["batch_size"]
    calls = ref.train_sampler_calls(b)
    fns = {"forward": C.sampler_forward_bytes,
           "dcoords": C.sampler_dcoords_bytes,
           "dimg": C.sampler_dimg_bytes}
    return {k: (len(v), sum(C.least_seconds(0, fns[k](*shape))
                            for shape in v))
            for k, v in calls.items()}
