"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives catgen_torch's sampling path (G32up-c generates, D32_st3 ranks, the
best 16 are searched against a corpus) on the card and checks it, phase by
phase; any failure ends the run with a non-zero exit code and no result.

  1. environment: torch, CUDA, the card, nvcc, triton, PIL;
  2. build: compiles catgen_torch/csrc/*.cu for sm_90a;
  3. the bilinear sampler kernel against its plain PyTorch version on the
     card, at both shapes the path gives it, N=256;
  4. the slice through catgen_torch.cli.sample.main: 1024 samples from a
     seeded checkpoint, with nearest neighbours against a fixture corpus;
     checks that the D batches went through the kernel;
  5. the same slice at count 64 on the card and on the CPU, compared;
  6. times: the kernel and its plain version, and the whole pipeline
     against a 16384-image corpus.

It prints a JSON line describing the kernels, the card's name and power
limit, and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import importlib
import json
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
KERNEL_TOL = 1e-5          # kernel vs plain, f32 (both round alike)
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


def perturb(g, d, seed: int) -> None:
    """Seeded weights that make the path do real work: the port's init,
    then every conv and dense kernel scaled by WEIGHT_GAIN (at the
    heuristic init each layer shrinks its activations and D's scores agree
    to ~1e-7), noisy ST heads (zero heads make every grid the identity,
    and the sampler would only read pixel centres) and noisy BatchNorm
    running statistics."""
    import torch
    from catgen_torch.core.module import reset_parameters

    gen = torch.Generator().manual_seed(seed)
    reset_parameters(g, gen)
    reset_parameters(d, gen)
    with torch.no_grad():
        for model in (g, d):
            for name, p in model.named_parameters():
                if ".head" in name:
                    noise = torch.randn(p.shape, generator=gen)
                    p.copy_(noise * 0.05 if name.endswith("weight")
                            else p + noise * 0.2)
                elif name.endswith("weight"):
                    p.mul_(WEIGHT_GAIN)
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


def slice_on_card(save: str) -> int:
    from catgen_torch.kernels import bilinear

    out = os.path.join(save, "samples_cuda")
    bilinear.LAUNCHES = 0
    result = run_cli(save, "cuda", COUNT, out)
    launches = bilinear.LAUNCHES
    expected = 2 * COUNT // 256
    print(f"sampler kernel launches during the CLI run: {launches} "
          f"(expected {expected}: 2 per D batch x {COUNT // 256} batches)")
    require(launches == expected, "the path did not go through the kernel")
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
    return launches


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
    phase(3, "kernel against its plain version")
    max_err = kernel_vs_plain()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as save:
        write_checkpoint(save)
        phase(4, f"the slice through the CLI, {COUNT} samples, on the card")
        launches = slice_on_card(save)
        phase(5, "the slice at count 64, card against CPU")
        card_vs_cpu(save)
        phase(6, "times on the card")
        t = times(save, card_name)
    kernels = [{
        "name": "bilinear_sample_rows",
        "route": "cuda",
        "source": "catgen_torch/csrc/bilinear_sample.cu",
        "replaces": "catgen/kernels/pallas_bilinear_v4.py:799",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": sum(t["kernel_ms"]),
        "plain_ms": sum(t["plain_ms"]),
        "ms_by_shape": dict(zip(map(str, SAMPLER_SHAPES), t["kernel_ms"])),
        "plain_ms_by_shape": dict(zip(map(str, SAMPLER_SHAPES),
                                      t["plain_ms"])),
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_name)     # as nvidia-smi gives it: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
