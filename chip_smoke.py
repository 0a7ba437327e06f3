"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives catgen_torch's two paths on the card, sampling (G32up-c generates,
D32_st3 ranks, the best 16 are searched against a corpus) and training
(G32up-c against D32_st3 through the training CLI), and checks them phase
by phase; any failure ends the run with a non-zero exit code and no
result.

  1. environment: torch, CUDA, the card, nvcc, triton, PIL;
  2. build: compiles catgen_torch/csrc/*.cu for sm_90a (one nvcc per
     source, in parallel);
  3. the sampler's forward kernel against its plain PyTorch version at
     both shapes of the sampling path, N=256;
  4. the sampler's backward kernels (d_img, d_coords) against the plain
     version's autograd at both shapes of the training path, N=640;
     repeats bit-identical; no d_img work where the image needs none;
  5. the sampling slice through catgen_torch.cli.sample.main: 1024 samples
     from a seeded checkpoint, nearest neighbours against a fixture corpus;
     checks that the D batches went through the kernel;
  6. the sampling slice at count 64 on the card and on the CPU, compared;
  7. sampling times: the forward kernel and its plain version, and the
     whole pipeline against a 16384-image corpus;
  8. the training slice through catgen_torch.cli.train.main: 2 epochs of
     20 steps at batch 64 with augmentation; checks the epochs, grids and
     checkpoint, the kernel launches per step, and that the sample CLI
     reads the checkpoint on the card;
  9. one train step at batch 8 on the card and on the CPU from the same
     weights and draws, compared;
 10. training times at batch 640 with augmentation (bench.py's training
     configuration): the step, its D and G phases and the optimizer, the
     sampler kernels against their plain versions at the training shapes,
     whether same-seed steps are bit-identical, and a profiled step.

It prints a JSON line describing the kernels, the card's name and power
limit, and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

N_SAMPLER = 256            # sampler batch: one D batch of the sampling path
SAMPLER_SHAPES = [         # (N, H, W, C, Ho, Wo) on D32_st3's path
    (N_SAMPLER, 32, 32, 3, 32, 32),    # input ST
    (N_SAMPLER, 16, 16, 64, 48, 16),   # three branch STs, stacked
]
TRAIN_B = 640              # bench.py's training batch
TRAIN_SHAPES = [           # the sampler in a training D batch of 640
    (TRAIN_B, 32, 32, 3, 32, 32),
    (TRAIN_B, 16, 16, 64, 48, 16),
]
KERNEL_TOL = 1e-5          # kernel vs plain, f32 (both round alike)
# backward kernels vs plain: the kernels sum over channels and output
# pixels in another order than autograd's reductions and scatter-adds, so
# they agree to f32 rounding of those sums: |err| <= atol + rtol*max|plain|
BWD_ATOL, BWD_RTOL = 1e-5, 1e-5
# card vs CPU, one train step (f32, TF32 off): losses rtol; gradients per
# leaf within GRAD_REL of the leaf's largest plus GRAD_FLOOR of the
# update's largest (leaves whose gradient is rounding noise, the upsample
# biases in front of BatchNorm). G's gradient is what is left of D's
# input-gradient paths after they largely cancel, and cuDNN's convolutions
# (FFT, implicit GEMM) sum in other orders than the CPU's, so G's leaves
# differ by up to ~2e-4 of their largest: GRAD_REL is 1e-3, ten times the
# CPU parity tests' 1e-4. Parameters within PARAM_ATOL, except that
# Adam's first step moves a weight by +-lr wherever |g| >> 3e-7, so a
# gradient whose sign is decided by rounding moves it 2*lr the other way:
# at most PARAM_FLIP_SHARE of the weights may differ, by at most 2*lr
STEP_LOSS_RTOL = 1e-5
GRAD_REL, GRAD_FLOOR = 1e-3, 1e-6
PARAM_ATOL, PARAM_FLIP_SHARE, PARAM_FLIP_MAX = 1e-4, 1e-4, 2.1e-3
G_GAIN, D_GAIN = 1.0, 2.0  # well-conditioned weights for the comparison
TRAIN_ARGS = ["--fixture", "256", "--epochs", "2", "--batchSize", "64",
              "--N_epoch", "640", "--augment"]
SLICE_ATOL = 1e-4          # card vs CPU: images and D scores
NN_RTOL = 1e-4             # card vs CPU: NN distances
COUNT = 1024
CORPUS = 1024              # fixture corpus of the CLI run
BENCH_CORPUS = 16384       # corpus of the pipeline timing (bench.py infer)
WEIGHT_GAIN = 4.0          # see perturb()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def phase(n: int, title: str) -> None:
    print(f"\n== phase {n}: {title}", flush=True)


def cuda_ms(fn, reps: int = 20, inner: int = 50, warmup: int = 3) -> float:
    """Per-call time in ms of ``fn``: the median of ``reps`` CUDA-event
    timings, each over ``inner`` back-to-back calls, after warm-up. One
    call per event pair would also count the host's launch latency."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def wall_ms(fn, reps: int = 10, warmup: int = 3):
    """(median, min, max) in ms of ``reps`` host-clock timings of ``fn``
    followed by a synchronize, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), min(walls), max(walls)


def environment() -> None:
    import torch
    from torch.utils import cpp_extension

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"torch.version.cuda {torch.version.cuda}")
    print(f"card: {card()}  (count {torch.cuda.device_count()})")
    nvcc = shutil.which("nvcc") or (
        cpp_extension.CUDA_HOME
        and os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc"))
    print(f"nvcc: {nvcc if nvcc and os.path.isfile(nvcc) else 'missing'}  "
          f"CUDA_HOME={os.environ.get('CUDA_HOME')}  "
          f"(torch finds {cpp_extension.CUDA_HOME})")
    for mod in ("triton", "PIL"):
        try:
            importlib.import_module(mod)
            print(f"{mod}: imports")
        except ImportError as e:
            print(f"{mod}: missing ({e})")


def build() -> None:
    from catgen_torch.kernels import build as kbuild

    t0 = time.perf_counter()
    path = kbuild.build_library()
    kbuild.load_library()
    print(f"built {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s")
    log = path.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())


def sampler_inputs(shape, seed):
    import torch

    n, h, w, c, ho, wo = shape
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand((n, h, w, c), generator=gen)
    rows = torch.rand((n, 2, ho * wo), generator=gen) * 2.4 - 1.2
    return img.cuda(), rows.cuda(), (ho, wo)


def kernel_vs_plain() -> float:
    import torch
    from catgen_torch.kernels import bilinear

    worst = 0.0
    for i, shape in enumerate(SAMPLER_SHAPES):
        img, rows, out_hw = sampler_inputs(shape, seed=10 + i)
        got = bilinear.launch(img, rows, out_hw)
        torch.cuda.synchronize()
        want = bilinear.bilinear_sample_rows_plain(img, rows, out_hw)
        require(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
        err = (got - want).abs().max().item()
        print(f"{shape}: max_abs_err {err:.3e} (tolerance {KERNEL_TOL})")
        require(err <= KERNEL_TOL, f"kernel disagrees with plain at {shape}")
        worst = max(worst, err)
    return worst


def perturb(g, d, seed: int, g_gain: float = WEIGHT_GAIN,
            d_gain: float = WEIGHT_GAIN) -> None:
    """Seeded weights that make the path do real work: the port's init,
    then every conv and dense kernel scaled by a gain (at the heuristic
    init each layer shrinks its activations and D's scores agree to
    ~1e-7), noisy ST heads (zero heads make every grid the identity, and
    the sampler would only read pixel centres) and noisy BatchNorm running
    statistics."""
    import torch
    from catgen_torch.core.module import reset_parameters

    gen = torch.Generator().manual_seed(seed)
    reset_parameters(g, gen)
    reset_parameters(d, gen)
    with torch.no_grad():
        for model, gain in ((g, g_gain), (d, d_gain)):
            for name, p in model.named_parameters():
                if ".head" in name:
                    noise = torch.randn(p.shape, generator=gen)
                    p.copy_(noise * 0.05 if name.endswith("weight")
                            else p + noise * 0.2)
                elif name.endswith("weight"):
                    p.mul_(gain)
            for name, b in model.named_buffers():
                if name.endswith("mean"):
                    b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
                elif name.endswith("var"):
                    b.copy_(torch.rand(b.shape, generator=gen) * 1.5 + 0.5)


def write_checkpoint(save: str) -> None:
    from catgen_torch import models
    from catgen_torch.data.fixture import write_fixture_dataset
    from catgen_torch.io import checkpoint
    from catgen_torch.io.convert import gan_to_leaves

    image, noise_dim = (32, 32, 3), 100
    g = models.create_G_decoder_upsampling32c(image, noise_dim)
    d = models.create_D32_st3(image)
    perturb(g, d, seed=1)
    meta = {"epoch": 0, "config": {"scale": 32, "colorspace": "rgb",
                                   "noise_dim": noise_dim,
                                   "g_model": "g32up_c",
                                   "d_model": "d32_st3"}}
    checkpoint.save(os.path.join(save, checkpoint.adversarial_filename()),
                    gan_to_leaves(g, d), meta)
    write_fixture_dataset(os.path.join(save, "fixture"), n=CORPUS)


def run_cli(save: str, device: str, count: int, out: str) -> dict:
    from catgen_torch.cli import sample as cli

    runs = cli.main(["--save", save, "--out", out, "--count", str(count),
                     "--neighbours", "--device", device, "--seed", "3"])
    require(len(runs) == 1, "one run expected")
    return runs[0]


def check_finite(result: dict) -> None:
    import torch

    for name in ("images", "scores", "best", "worst", "random"):
        require(bool(torch.isfinite(result[name]).all()),
                f"non-finite values in {name}")
    nb = result["neighbours"]
    require(bool(torch.isfinite(nb["distances"]).all()),
            "non-finite NN distances")


def reset_counts() -> None:
    from catgen_torch.kernels import bilinear

    bilinear.LAUNCHES = bilinear.DCOORDS_LAUNCHES = bilinear.DIMG_LAUNCHES = 0


def read_counts() -> tuple:
    """(forward, d_coords, d_img) launches since the last reset."""
    from catgen_torch.kernels import bilinear

    return (bilinear.LAUNCHES, bilinear.DCOORDS_LAUNCHES,
            bilinear.DIMG_LAUNCHES)


def slice_on_card(save: str) -> tuple:
    out = os.path.join(save, "samples_cuda")
    reset_counts()
    result = run_cli(save, "cuda", COUNT, out)
    counts = read_counts()
    launches = counts[0]
    expected = 2 * COUNT // 256
    print(f"sampler kernel launches during the CLI run: {launches} "
          f"(expected {expected}: 2 per D batch x {COUNT // 256} batches)")
    require(launches == expected, "the path did not go through the kernel")
    require(counts[1:] == (0, 0), f"backward kernels launched while "
            f"sampling: {counts}")
    require(tuple(result["images"].shape) == (COUNT, 32, 32, 3),
            f"images {tuple(result['images'].shape)}")
    require(result["images"].is_cuda, "images not on the card")
    check_finite(result)
    for name in ("real64", "random256", f"random{COUNT}", "best64",
                 "worst64", "neighbours"):
        path = os.path.join(out, f"run0_{name}.png")
        require(os.path.getsize(path) > 0, f"missing grid {path}")
    s = result["scores"]
    print(f"D scores: min {s.min().item():.6f} max {s.max().item():.6f} "
          f"std {s.std().item():.6f}; NN distances mean "
          f"{result['neighbours']['distances'].mean().item():.4f}")
    require(s.std().item() > 1e-3, "D scores are flat")
    return counts


def card_vs_cpu(save: str) -> None:
    import torch
    from catgen_torch.data.loader import ImageDataset
    from catgen_torch.sample import nearest_neighbours

    res = {dev: run_cli(save, dev, 64, os.path.join(save, f"cmp_{dev}"))
           for dev in ("cuda", "cpu")}
    gpu, cpu = res["cuda"], res["cpu"]
    img_err = (gpu["images"].cpu() - cpu["images"]).abs().max().item()
    score_err = (gpu["scores"].cpu() - cpu["scores"]).abs().max().item()
    print(f"images max_abs_err {img_err:.3e}, D scores max_abs_err "
          f"{score_err:.3e} (tolerance {SLICE_ATOL})")
    require(img_err <= SLICE_ATOL, "images differ between card and CPU")
    require(score_err <= SLICE_ATOL, "D scores differ between card and CPU")
    # the order is defined where neighbouring scores differ by more than
    # the tolerance; the NN search runs on the same 16 queries both sides
    s = cpu["scores"][cpu["order"]]
    gap = (s[:-1] - s[1:]).abs() > 2 * SLICE_ATOL
    true = torch.ones(1, dtype=torch.bool)
    defined = torch.cat([true, gap]) & torch.cat([gap, true])
    same = gpu["order"].cpu() == cpu["order"]
    require(bool(same[defined].all()), "ranking differs between card and CPU")
    corpus = ImageDataset([os.path.join(save, "fixture")]).load_images(
        0, CORPUS)
    q = cpu["order"][:16]
    idx_c, dist_c = nearest_neighbours(cpu["images"][q], corpus)
    idx_g, dist_g = nearest_neighbours(gpu["images"][q.cuda()],
                                       corpus.cuda())
    rel = ((dist_g.cpu() - dist_c).abs() / dist_c).max().item()
    d2 = torch.cdist(cpu["images"][q].reshape(16, -1),
                     corpus.reshape(CORPUS, -1))
    two = torch.sort(d2, dim=1).values[:, :2]
    clear = (two[:, 1] - two[:, 0]) > NN_RTOL * two[:, 1]
    agree = (idx_g.cpu() == idx_c)[clear]
    print(f"NN distances max rel err {rel:.3e} (tolerance {NN_RTOL}); "
          f"indices agree on {int(agree.sum())}/{int(clear.sum())} "
          f"queries with a clear nearest neighbour")
    require(rel <= NN_RTOL, "NN distances differ between card and CPU")
    require(bool(clear.any()), "no query has a clear nearest neighbour")
    require(bool(agree.all()), "NN indices differ between card and CPU")


def times(save: str, card_name: str) -> dict:
    import torch
    from catgen_torch.cli.sample import load_gan
    from catgen_torch.kernels import bilinear
    from catgen_torch.sample import (generate_batched, neighbours_of_best,
                                     rank_by_d, sample_and_rank)
    from catgen_torch.train.gan import uniform_noise

    out = {"kernel_ms": [], "plain_ms": []}
    for i, shape in enumerate(SAMPLER_SHAPES):
        img, rows, out_hw = sampler_inputs(shape, seed=20 + i)
        plain = cuda_ms(lambda: bilinear.bilinear_sample_rows_plain(
            img, rows, out_hw))
        kern = cuda_ms(lambda: bilinear.launch(img, rows, out_hw))
        plain2 = cuda_ms(lambda: bilinear.bilinear_sample_rows_plain(
            img, rows, out_hw))
        kern2 = cuda_ms(lambda: bilinear.launch(img, rows, out_hw))
        kern, plain = min(kern, kern2), min(plain, plain2)
        out["kernel_ms"].append(kern)
        out["plain_ms"].append(plain)
        print(f"sampler {shape}: kernel {kern:.4f} ms, plain {plain:.4f} ms "
              f"(CUDA events, median of 20 timings of 50 back-to-back "
              f"calls, order plain-kernel-plain-kernel, best of the two "
              f"medians; {card_name})")

    device = torch.device("cuda")
    g, d, config = load_gan(os.path.join(save, "adversarial.ckpt"), device)
    gen = torch.Generator().manual_seed(7)
    corpus = torch.rand((BENCH_CORPUS, 32, 32, 3), generator=gen).to(device)

    def pipeline():
        result = sample_and_rank(g, d, gen, noise_dim=config.noise_dim,
                                 count=COUNT, device=device)
        return neighbours_of_best(result, corpus, n_best=16)

    med, lo, hi = wall_ms(pipeline)
    sps = COUNT / med * 1e3
    print(f"pipeline ({COUNT} generated + D-ranked + NN vs {BENCH_CORPUS}): "
          f"median {med:.3f} ms of 10 (min {lo:.3f}, max {hi:.3f}) = "
          f"{sps:.1f} samples/s; {card_name}")
    out.update(pipeline_ms=med, samples_per_s=sps)

    noise = uniform_noise(gen, COUNT, config.noise_dim, device)
    images = generate_batched(g, noise)
    result = sample_and_rank(g, d, gen, noise_dim=config.noise_dim,
                             count=COUNT, device=device)
    for name, fn in (("G generate_batched",
                      lambda: generate_batched(g, noise)),
                     ("D rank_by_d", lambda: rank_by_d(d, images)),
                     ("NN neighbours_of_best",
                      lambda: neighbours_of_best(result, corpus))):
        med, lo, hi = wall_ms(fn)
        print(f"stage {name}: median {med:.3f} ms of 10 (min {lo:.3f}, "
              f"max {hi:.3f}); {card_name}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    # (event, its own device time in us) for every kernel on the card
    kernels = [(e, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(us for _, us in kernels)
    if busy_us == 0:
        print("profiler: no device time seen; breakdown not measured")
        return out
    print(f"profiled pipeline run: wall {traced_wall * 1e3:.3f} ms, device "
          f"kernels {busy_us / 1e3:.3f} ms, device idle share "
          f"{1 - busy_us / 1e6 / traced_wall:.3f}")
    for e, us in sorted(kernels, key=lambda k: -k[1])[:12]:
        print(f"  {us / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    for e, us in kernels:
        if "sample_rows" in e.key:
            print(f"sampler kernel in the pipeline: {e.key[:60]} "
                  f"{us / e.count / 1e3:.4f} ms device time per launch "
                  f"(x{e.count}); {card_name}")
    return out


def backward_vs_plain() -> dict:
    """The d_img and d_coords kernels against the plain version's autograd
    at the training shapes; repeats bit-identical; a sampled image that
    needs no gradient launches no d_img kernel. Returns the max abs errors
    {'dimg': ..., 'dcoords': ...}."""
    import torch
    from catgen_torch.kernels import bilinear

    worst = {"dimg": 0.0, "dcoords": 0.0}
    for i, shape in enumerate(TRAIN_SHAPES):
        img, rows, out_hw = sampler_inputs(shape, seed=30 + i)
        gen = torch.Generator().manual_seed(40 + i)
        g = (torch.rand((shape[0], *out_hw, shape[3]), generator=gen)
             * 2 - 1).cuda()
        got = {"dimg": bilinear.launch_dimg(img, rows, g, out_hw),
               "dcoords": bilinear.launch_dcoords(img, rows, g, out_hw)}
        again = {"dimg": bilinear.launch_dimg(img, rows, g, out_hw),
                 "dcoords": bilinear.launch_dcoords(img, rows, g, out_hw)}
        torch.cuda.synchronize()
        want = dict(zip(("dimg", "dcoords"),
                        bilinear.bilinear_sample_rows_backward_plain(
                            img, rows, g, out_hw)))
        for name in ("dimg", "dcoords"):
            require(got[name].shape == want[name].shape,
                    f"{name} shape {tuple(got[name].shape)}")
            err = (got[name] - want[name]).abs().max().item()
            bound = BWD_ATOL + BWD_RTOL * want[name].abs().max().item()
            same = torch.equal(got[name], again[name])
            print(f"{shape} {name}: max_abs_err {err:.3e} (tolerance "
                  f"{bound:.3e} = {BWD_ATOL} + {BWD_RTOL} x max |plain| "
                  f"{want[name].abs().max().item():.4f}; sum order); "
                  f"repeat bit-identical: {same}")
            require(err <= bound, f"{name} kernel disagrees at {shape}")
            require(same, f"{name} kernel is not deterministic at {shape}")
            worst[name] = max(worst[name], err)
    img, rows, out_hw = sampler_inputs(TRAIN_SHAPES[0], seed=50)
    rows.requires_grad_(True)
    reset_counts()
    bilinear.bilinear_sample_rows(img, rows, out_hw).sum().backward()
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"image needs no gradient: launches (fwd, d_coords, d_img) = "
          f"{counts}")
    require(counts == (1, 1, 0), "a d_img kernel ran for a data image")
    return worst


def train_on_card(save: str) -> tuple:
    """The training CLI on the card; returns its (fwd, d_coords, d_img)
    launch counts and the number of steps."""
    from catgen_torch.cli import sample as sample_cli
    from catgen_torch.cli import train as train_cli

    reset_counts()
    harness = train_cli.main(TRAIN_ARGS + ["--device", "cuda", "--save",
                                           save])
    counts = read_counts()
    steps, vizzes = harness.state.step, 2
    # per step: augmentation 1 + D phase 2 + G phase 2 forwards; d_coords
    # at all 4 transformer sites; d_img at 3 (not the D phase's input ST,
    # which samples data). Each visualization runs D twice (samples,
    # probes), 2 forwards each
    expected = (5 * steps + 4 * vizzes, 4 * steps, 3 * steps)
    print(f"training CLI: {steps} steps; kernel launches (fwd, d_coords, "
          f"d_img) {counts}, expected {expected}: per step "
          f"{(counts[0] - 4 * vizzes) / steps:g} / {counts[1] / steps:g} / "
          f"{counts[2] / steps:g}")
    require(counts == expected, "the training path's kernel launches")
    with open(os.path.join(save, "train_metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    epochs = [e for e in events if e["event"] == "epoch"]
    for e in epochs:
        print(f"epoch {e['epoch']}: loss_d {e['loss_d']:.5f} loss_g "
              f"{e['loss_g']:.5f} acc_d {e['acc_d']:.4f} "
              f"{e['imgs_per_sec']} imgs/s (CLI clock, first epoch "
              f"includes warm-up)")
    require(len(epochs) == 2, f"{len(epochs)} epoch lines, not 2")
    require(all(math.isfinite(e[k]) for e in epochs
                for k in ("loss_d", "loss_g")), "non-finite losses")
    for epoch in (1, 2):
        for d in ("images", "images_good", "images_bad", "images_real"):
            path = os.path.join(save, d, f"epoch_{epoch:06d}.png")
            require(os.path.getsize(path) > 0, f"missing grid {path}")
    ckpt = os.path.join(save, "adversarial.ckpt")
    require(os.path.getsize(ckpt) > 0, "no checkpoint written")
    runs = sample_cli.main(["--save", save, "--count", "256", "--device",
                            "cuda", "--neighbours"])
    check_finite(runs[0])
    require(runs[0]["images"].is_cuda, "sampled images not on the card")
    print(f"sample CLI read {ckpt} on the card: 256 images, D scores "
          f"{runs[0]['scores'].min().item():.4f}..."
          f"{runs[0]['scores'].max().item():.4f}")
    return counts, steps


class RecordingDraws:
    """Draws that also keep what they drew, in order."""

    def __init__(self, draws):
        self.draws, self.taken = draws, []

    def _keep(self, t):
        self.taken.append(t)
        return t

    def uniform(self, shape, low=0.0, high=1.0):
        return self._keep(self.draws.uniform(shape, low, high))

    def bernoulli(self, p, shape):
        return self._keep(self.draws.bernoulli(p, shape))

    def normal(self, shape):
        return self._keep(self.draws.normal(shape))


class ReplayedDraws:
    """Hands out recorded draws, in order, on ``device``."""

    def __init__(self, taken, device):
        self.taken, self.device = list(taken), device

    def _next(self, shape):
        t = self.taken.pop(0)
        require(tuple(t.shape) == tuple(shape), "draws out of order")
        return t.to(self.device)

    def uniform(self, shape, low=0.0, high=1.0):
        return self._next(shape)

    def bernoulli(self, p, shape):
        return self._next(shape)

    def normal(self, shape):
        return self._next(shape)


def seeded_pair(seed: int, g_gain: float, d_gain: float):
    from catgen_torch import models

    g = models.create_G_decoder_upsampling32c((32, 32, 3), 100)
    d = models.create_D32_st3((32, 32, 3))
    perturb(g, d, seed, g_gain, d_gain)
    return g, d


def step_card_vs_cpu() -> dict:
    """One train step at batch 8 with augmentation on the CPU and on the
    card, from the same weights and the same draws: losses, gradients and
    parameters after the step."""
    import copy

    import torch
    from catgen_torch import optim
    from catgen_torch.core.random import Draws
    from catgen_torch.train import gan

    config = gan.GanConfig(batch_size=8, augment=True)
    g, d = seeded_pair(3, G_GAIN, D_GAIN)
    reals = torch.rand((4, 32, 32, 3),
                       generator=torch.Generator().manual_seed(4))
    out = {}
    real_cap = optim.clamp_and_penalize
    for dev in ("cpu", "cuda"):
        gd, dd = copy.deepcopy(g).to(dev), copy.deepcopy(d).to(dev)
        state = gan.init_state(gd, dd, config)
        grads = []

        def spy(gr, *a, **k):
            grads.append({n: t.detach().cpu() for n, t in gr.items()})
            return real_cap(gr, *a, **k)

        if dev == "cpu":
            draws = RecordingDraws(Draws(torch.Generator().manual_seed(5)))
        else:
            draws = ReplayedDraws(recorded.taken, dev)
        optim.clamp_and_penalize = spy
        try:
            m = gan.make_train_step(gd, dd, config)(state, reals.to(dev),
                                                     draws)
        finally:
            optim.clamp_and_penalize = real_cap
        if dev == "cpu":
            recorded = draws
        out[dev] = (m, grads, {**{f"g.{k}": v.cpu() for k, v in
                                  gd.state_dict().items()},
                               **{f"d.{k}": v.cpu() for k, v in
                                  dd.state_dict().items()}})
    (mc, gc, pc), (mg, gg, pg) = out["cpu"], out["cuda"]
    for name in ("loss_d", "loss_g", "acc_d", "acc_avg"):
        a, b = float(getattr(mg, name)), float(getattr(mc, name))
        print(f"{name}: card {a:.7f} cpu {b:.7f} rel err "
              f"{abs(a - b) / max(abs(b), 1e-30):.2e} "
              f"(tolerance {STEP_LOSS_RTOL})")
        require(abs(a - b) <= STEP_LOSS_RTOL * abs(b), f"{name} differs")
    for name in ("d_trained", "tp_real", "tn_fake", "fp", "fn"):
        require(float(getattr(mg, name)) == float(getattr(mc, name)),
                f"{name} differs")
    worst_grad = 0.0
    for phase_name, a, b in zip("DG", gg, gc):
        top = max(v.abs().max().item() for v in b.values())
        rel = []
        for k in b:
            err = (a[k] - b[k]).abs().max().item()
            bound = GRAD_REL * b[k].abs().max().item() + GRAD_FLOOR * top
            require(err <= bound, f"{phase_name} gradient {k}: {err:.3e} > "
                                  f"{bound:.3e}")
            if err > GRAD_FLOOR * top:    # not a rounding-noise leaf
                rel.append((err / b[k].abs().max().item(), k))
        rel.sort(reverse=True)
        worst_grad = max([worst_grad] + [r for r, _ in rel])
        print(f"{phase_name} phase gradients, worst leaves (error over the "
              f"leaf's largest): " + ", ".join(
                  f"{k} {r:.2e}" for r, k in rel[:3]))
    print(f"gradients: worst per-leaf error {worst_grad:.2e} of the leaf's "
          f"largest (tolerance {GRAD_REL} + {GRAD_FLOOR} of the update's "
          f"largest)")
    n = beyond = 0
    worst = 0.0
    for k, want in pc.items():
        err = (pg[k] - want).abs()
        n += err.numel()
        beyond += int((err > PARAM_ATOL).sum())
        worst = max(worst, err.max().item())
    print(f"parameters after the step: max abs err {worst:.3e}; "
          f"{beyond} of {n} beyond {PARAM_ATOL} (Adam sign flips; allowed "
          f"{PARAM_FLIP_SHARE:g} of them, each <= {PARAM_FLIP_MAX})")
    require(worst <= PARAM_FLIP_MAX, "parameters differ by more than 2*lr")
    require(beyond <= PARAM_FLIP_SHARE * n, "too many parameters differ")
    return {"grad_rel": worst_grad, "param_abs": worst}


def train_times(card_name: str) -> dict:
    """The train step at batch 640 with augmentation, f32, TF32 off."""
    import copy

    import torch
    from catgen_torch import optim
    from catgen_torch.core.random import Draws
    from catgen_torch.kernels import bilinear
    from catgen_torch.nn.layers import set_draws
    from catgen_torch.train import gan

    device = torch.device("cuda")
    config = gan.GanConfig(batch_size=TRAIN_B, augment=True)
    g, d = seeded_pair(6, G_GAIN, D_GAIN)
    g, d = g.to(device), d.to(device)
    state = gan.init_state(g, d, config)
    step = gan.make_train_step(g, d, config)
    reals = torch.rand((TRAIN_B // 2, 32, 32, 3), device=device)
    draws = Draws(torch.Generator(device).manual_seed(0))
    out = {}

    med, lo, hi = wall_ms(lambda: step(state, reals, draws), reps=12)
    ips = 2 * TRAIN_B / med * 1e3
    print(f"train step, batch {TRAIN_B}, augment: median {med:.3f} ms of "
          f"12 (min {lo:.3f}, max {hi:.3f}) = {ips:.1f} images/s "
          f"(2 x batch per step, bench.py's accounting); {card_name}")
    out.update(step_ms=med, images_per_s=ips)
    split = {
        "D phase (G forward, D forward+backward, its Adam update)":
            lambda: step.d_phase(state, reals, draws),
        "G phase (G and D forward+backward, its Adam update)":
            lambda: step.g_phase(state, draws, device),
    }
    d_opt, g_opt = config.make_optimizers()
    for name, module, opt, attr in (("D", d, d_opt, "d_opt"),
                                    ("G", g, g_opt, "g_opt")):
        params = gan.params_of(module)
        grads = {k: torch.randn_like(p) * 1e-3 for k, p in params.items()}

        def update(params=params, grads=grads, opt=opt, attr=attr):
            gr = optim.clamp_and_penalize(grads, params, 0.0, 1e-4, 1.0)
            upd, new = opt.update(gr, getattr(state, attr))
            new_params = optim.apply_updates(params, upd)
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(new_params[k])
            setattr(state, attr, new)

        split[f"{name} optimizer alone (penalty, clamp, Adam, write)"] = \
            update
    for name, fn in split.items():
        pm, plo, phi = wall_ms(fn, reps=10)
        print(f"  {name}: median {pm:.3f} ms of 10 (min {plo:.3f}, max "
              f"{phi:.3f})")
        out[name] = pm

    # same-seed steps, bit for bit, under two cuDNN settings (from copies
    # of the state; the dropout layers let go of the step's draws first)
    set_draws(g, None)
    set_draws(d, None)
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        runs = []
        for _ in range(2):
            s2 = copy.deepcopy(state)
            st2 = gan.make_train_step(s2.g, s2.d, config)
            st2(s2, reals, Draws(torch.Generator(device).manual_seed(9)))
            torch.cuda.synchronize()
            runs.append([t.clone() for t in s2.g.state_dict().values()]
                        + [t.clone() for t in s2.d.state_dict().values()])
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"two same-seed steps bit-identical with "
              f"cudnn.deterministic={deterministic}, cudnn.benchmark="
              f"{torch.backends.cudnn.benchmark}: {same}")
        out[f"bit_identical_deterministic_{deterministic}"] = same
    torch.backends.cudnn.deterministic = False

    # the sampler kernels against their plain versions, training shapes
    out["fwd"], out["fwd_plain"] = [], []
    out["dcoords"], out["dcoords_plain"] = [], []
    out["dimg"], out["dimg_plain"] = [], []
    for i, shape in enumerate(TRAIN_SHAPES):
        img, rows, out_hw = sampler_inputs(shape, seed=60 + i)
        gcot = torch.rand((shape[0], *out_hw, shape[3]), device=device)
        pairs = {
            "fwd": (lambda: bilinear.launch(img, rows, out_hw),
                    lambda: bilinear.bilinear_sample_rows_plain(
                        img, rows, out_hw)),
            "dcoords": (lambda: bilinear.launch_dcoords(img, rows, gcot,
                                                        out_hw),
                        lambda: bilinear.bilinear_sample_rows_backward_plain(
                            img, rows, gcot, out_hw, need_img=False)),
            "dimg": (lambda: bilinear.launch_dimg(img, rows, gcot, out_hw),
                     lambda: bilinear.bilinear_sample_rows_backward_plain(
                         img, rows, gcot, out_hw, need_coords=False)),
        }
        for name, (kern, plain) in pairs.items():
            p1, k1 = cuda_ms(plain, inner=10), cuda_ms(kern, inner=10)
            k2, p2 = cuda_ms(kern, inner=10), cuda_ms(plain, inner=10)
            out[name].append(min(k1, k2))
            out[f"{name}_plain"].append(min(p1, p2))
            print(f"sampler {name} {shape}: kernel {min(k1, k2):.4f} ms, "
                  f"plain {min(p1, p2):.4f} ms (CUDA events, median of 20 "
                  f"timings of 10 back-to-back calls, order plain-kernel-"
                  f"kernel-plain, best of the two medians); {card_name}")

    from torch.profiler import ProfilerActivity, profile
    step(state, reals, draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, reals, draws)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    kernels = [(e, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(us for _, us in kernels)
    if busy_us == 0:
        print("profiler: no device time seen; breakdown not measured")
        return out
    idle = 1 - busy_us / 1e6 / traced_wall
    print(f"profiled train step: wall {traced_wall * 1e3:.3f} ms, device "
          f"kernels {busy_us / 1e3:.3f} ms, device idle share {idle:.3f}")
    out["idle_share"] = idle
    for e, us in sorted(kernels, key=lambda k: -k[1])[:15]:
        print(f"  {us / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    for e, us in kernels:
        if "sample_rows" in e.key or "dcoords" in e.key or "dimg" in e.key:
            print(f"sampler kernel in the step: {e.key[:70]} "
                  f"{us / e.count / 1e3:.4f} ms device time per launch "
                  f"(x{e.count}); {card_name}")
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase(1, "environment")
    environment()
    card_name = card()
    phase(2, "build")
    build()
    phase(3, "forward kernel against its plain version")
    max_err = kernel_vs_plain()
    phase(4, "backward kernels against the plain version's autograd")
    bwd_err = backward_vs_plain()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as save:
        write_checkpoint(save)
        phase(5, f"the sampling slice through the CLI, {COUNT} samples")
        sample_counts = slice_on_card(save)
        phase(6, "the sampling slice at count 64, card against CPU")
        card_vs_cpu(save)
        phase(7, "sampling times on the card")
        t = times(save, card_name)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as save:
        phase(8, "the training slice through the CLI")
        train_counts, steps = train_on_card(save)
    phase(9, "one train step, card against CPU")
    step_card_vs_cpu()
    phase(10, f"training times on the card, batch {TRAIN_B}")
    tt = train_times(card_name)

    def by_shape(values):
        return dict(zip(map(str, TRAIN_SHAPES), values))

    source_fwd = "catgen_torch/csrc/bilinear_sample.cu"
    source_bwd = "catgen_torch/csrc/bilinear_sample_bwd.cu"
    kernels = []
    for i, (name, source, err) in enumerate((
            ("bilinear_sample_rows", source_fwd, max_err),
            ("bilinear_sample_rows_bwd_dcoords", source_bwd,
             bwd_err["dcoords"]),
            ("bilinear_sample_rows_bwd_dimg", source_bwd, bwd_err["dimg"]))):
        key = ("fwd", "dcoords", "dimg")[i]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": ("catgen/kernels/pallas_bilinear_v4.py:799" if i == 0
                         else "catgen/kernels/pallas_bilinear_v4.py:917"),
            "launches": train_counts[i],
            "launches_by_path": {"sample": sample_counts[i],
                                 "train": train_counts[i]},
            "max_abs_err": err,
            "ms": sum(tt[key]), "plain_ms": sum(tt[f"{key}_plain"]),
            "ms_by_shape": by_shape(tt[key]),
            "plain_ms_by_shape": by_shape(tt[f"{key}_plain"]),
        })
    kernels[0]["sampling_ms_by_shape"] = dict(zip(map(str, SAMPLER_SHAPES),
                                                  t["kernel_ms"]))
    kernels[0]["sampling_plain_ms_by_shape"] = dict(
        zip(map(str, SAMPLER_SHAPES), t["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card_name)     # as nvidia-smi gives it: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
