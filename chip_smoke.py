"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives catgen_torch's paths on the card, sampling (G32up-c generates,
D32_st3 ranks, the best 16 are searched against a corpus) and training
(G32up-c against D32_st3 through the training CLI), on the default route
(G's upsample-convs on cuDNN, D's spatial transformers on the v4 sampler
kernels), on G's kernel route (the hand-written upsample-conv kernels, as
the ladder and per layer), on D's fused-prefix route (the ST-conv kernel)
and on the grid-sampler route (the v1-v3 generations), then the
reference's workflow (the V trainer, the G pretrainer, the GAN run that
picks up both), and checks them phase by phase; any failure ends the run
with a non-zero exit code and no result.

  1. environment: torch, CUDA, the card, nvcc, triton, PIL;
  2. build: compiles catgen_torch/csrc/*.cu for sm_90a (one nvcc per
     source, in parallel); the SASS of every instantiation of the dCK, dX
     and forward upsample-conv kernels holds tensor-core products of its
     type, TF32 for f32 (3xTF32) and BF16 for bf16 (cuobjdump: HMMA for
     the f32 dCK's mma.sync, HGMMA for the wgmma of the forward, dX and
     the bf16 dCK), and so does the bf16 ST-conv's tensor-core kernel
     (BF16 HMMA from mma.sync);
  3. the sampler's forward kernel against its plain PyTorch version at
     both shapes of the sampling path, N=256, with the forward kernel each
     shape takes (per quad, staged); both bit for bit against the plain
     version and against the kernel a misaligned image takes (per pixel,
     per value);
  4. the sampler's backward kernels (d_img, d_coords) against the plain
     version's autograd at both shapes of the training path, N=640, at a
     32x32x64 image, N=64, and at the input ST's shape with a zoomed-in
     transform (many output pixels on one tap), with the d_coords and
     d_img kernel each shape takes (d_coords per pixel, staged, per warp;
     d_img per sample, gather, gather); repeats bit-identical; no d_img
     work where the image needs none;
  5. the sampling slice through catgen_torch.cli.sample.main: 1024 samples
     from a seeded checkpoint, nearest neighbours against a fixture corpus;
     checks that the D batches went through the kernel;
  6. the sampling slice at count 64 on the card and on the CPU, compared;
  7. sampling times: the forward kernel and its plain version, and the
     whole pipeline against a 16384-image corpus;
  8. the training slice through catgen_torch.cli.train.main: 2 epochs of
     20 steps at batch 64 with augmentation; checks the epochs, grids and
     checkpoint, the kernel launches per step, and that the sample CLI
     reads the checkpoint on the card; then the CLI twice from one seed,
     one epoch each, started with TF32 on and cuDNN nondeterministic: the
     CLI sets full f32 and deterministic cuDNN, and the two checkpoints
     hold the same bits;
  9. one train step at batch 8 on the card (cuDNN's deterministic
     algorithms) and on the CPU from the same weights and draws,
     compared;
 10. training times at batch 640 with augmentation (bench.py's training
     configuration): the step with and without cuDNN's deterministic
     algorithms, its D and G phases and the optimizer, the sampler
     kernels against their plain versions and grid_sample at the
     training shapes, whether same-seed steps are bit-identical, and a
     profiled step; each sampler kernel's device time against its library
     call's (grid_sample, grid_sampler_2d_backward), from profiled sessions
     of at least 100 calls and 20 ms;
 11. the upsample-conv kernels against their plain versions at G32up-c's
     three stage shapes, N=640 and N=320, dCK in all four fold/transform
     variants; repeats bit-identical; the forward (rows 3 and 4), dCK's
     dW and db, dX and the plain version against float64 at N=640;
 12. the sampling CLI on the ladder route (CATGEN_UPSAMPLE_IMPL=pallas,
     CATGEN_FUSED_LADDER=1): 3 block launches per G batch, the same
     images as phase 5;
 13. the training CLI on the ladder route with the block backward
     kernels (CATGEN_LADDER_BWD=pallas): launches per step and per
     visualization; the sample CLI reads its checkpoint;
 14. one train step on the per-layer route (CATGEN_FUSED_LADDER=0) with
     CATGEN_UPSAMPLE_BWD=pallas and =hybrid: launches, and losses equal
     to the default route's;
 15. one train step on the ladder route, card against CPU (the CPU runs
     the kernels' plain versions), within phase 9's bounds;
 16. at batch 640: each upsample-conv kernel against its plain version,
     the cuDNN collapsed route and its bound (forward, dX and dCK: 3xTF32
     and f32), at each stage shape, dX also in device time beside cuDNN
     dgrad's; the train step on the ladder and per-layer routes, profiled;
 17. the fused ST-conv kernel against its plain version at D32_st3's
     prefix, N=640 and 256, shared and per-channel slope: out, samp and z;
     repeats bit-identical; both shapes take the tiled kernel
     (st_conv.f32_kind and the profiler's name), whose out, z and samp are
     the bits of the banded kernel (a misaligned image takes it);
 18. D's fused-prefix route (CATGEN_ST_CONV=fused): the sampling CLI (1
     ST-conv and 1 v4 launch per D batch, the same images and scores as
     phase 5), the training CLI (per step 2 ST-conv, 3 v4 forwards, 4
     d_coords, 3 d_img), one train step card against CPU;
 19. the grid-layout sampler kernels against their plain versions at
     phase 4's shapes (the per-quad and staged forwards bit for bit); the
     grid route
     (CATGEN_SAMPLER_IMPL=mxu,
     CATGEN_SAMPLER_KERNEL=v1): the sampling CLI (2 grid forwards per D
     batch, no v4 launch) and the training CLI (per step 5 grid forwards,
     4 d_coords, 3 d_img); one train step each on v2 and v3;
 20. times at batch 640: the ST-conv kernel, its plain version, the split
     route and its bound, and the banded kernel beside it in device
     time; the grid kernels, their plain versions,
     grid_sample and the bound (each also in device time beside its
     library call's); the train step on the fused-prefix, v1 and default
     routes, profiled;
 21. the grid forward kernel at the V warp generator's shape (C=3, 32x32
     -> 32x32) against its plain version, bit for bit, at half batches of
     16 and 320, on the generator's grids, which run past every edge;
 22. the V trainer through catgen_torch.cli.train_v.main: 2 epochs at the
     reference's batch 32 with catgen's full overlay bank (its seconds
     printed): the epochs, the grids, the V checkpoint, and one grid
     forward launch per warp batch of the host's generator choices; one V
     step at batch 8 on the card and on the CPU from the same weights,
     fakes and draws, within phase 9's bounds;
 23. the G pretrainer through catgen_torch.cli.pretrain_g.main on the
     default route and on the ladder route (3 block forwards, 3 dX and 3
     dCK per step, 3 block forwards per reconstruction grid); one ladder
     step card against CPU within phase 15's bounds;
 24. the workflow: the training CLI in the same --save picks up the V
     checkpoint and the pretrained G and logs V's ratings; the sample CLI
     reads its checkpoint;
 25. at the reference's batch 32 and bench.py's 640: a V batch's
     generation (each generator, each overlay kind, the pixelwise scan's
     host walk) and update, profiled; the pretrain step at 640 on both
     routes, profiled;
 26. the sampler kernels' bf16 instantiations against their bf16 plain
     versions (upcast, f32 arithmetic, one rounding) at phase 4's shapes,
     rows and grid layouts, and at the augmentation's own coordinates:
     the kernel each bf16 shape takes (d_coords per quad at the input
     ST); the forward bit for bit (a misaligned image too); d_img and
     d_coords within one bf16 unit in the last place plus 2^-16 of the
     largest, repeats bit for bit; the per-quad d_coords bit for bit
     against the per-pixel kernel (a misaligned image);
 27. the training CLI with --dtype bf16 --augment (one epoch of 20 steps
     at batch 64): 5 forward, 4 d_coords and 3 d_img bf16 launches a step;
     the sample CLI reads the checkpoint; twice from one seed, the same
     checkpoint bits; one bf16 step on the v1 grid route (the grid
     kernels' bf16 launches, the per-quad d_coords twice by the
     profiler's names);
 28. one bf16 step at batch 8, and the same step with remat, on the card
     and on the CPU from the same weights and draws: on each device the
     remat step is the plain step bit for bit and draws the same; card
     against CPU within bf16 bounds;
 29. at batch 640 (bench.py's configuration) in one run: the f32 and bf16
     steps and both with remat (time, images/s, idle share, peak memory;
     the bf16 step launches the per-quad d_coords twice and the bf16
     per-pixel one never, by the profiler's names),
     the V update in f32 and bf16, and each bf16 sampler kernel, rows and
     grid, against its plain version, its bf16 library call and its bf16
     bound (the rows kernels also in device time);
 30. phase 11 for the upsample-conv kernels' bf16 instantiations (bf16
     wgmma; the bf16 block runs its input transform and its cotangent
     fold as passes of their own, held bit for bit against their plain
     versions, dbias within 1e-4; the block backward folds once and its
     dX and dCK read the fold's output, the block dX also held alone on
     it) against their bf16 plain versions: bf16
     outputs
     within one unit in the last place plus 2^-16 of the largest, dW and
     db (sums over the batch) plus 1e-4, f32 sums within 1e-4 of the
     largest, repeats bit for bit; dCK's dW and db within one unit plus
     2^-16 of float64 rounded once, the plain version's reading beside
     it, and three planted rounding faults that the 1e-4 floor must fail;
     which kernel the bf16 forward takes: the warp-specialised TMA kernel
     at every stage shape (its box of x), the cp.async kernel at stage 1 with
     a misaligned x and at 6x6 images (no box), both held against the
     plain version;
 31. phase 17 for the ST-conv kernel's bf16 instantiation against its
     bf16 plain version (N=640 and 256, shared and per-channel slope):
     out and z within one unit plus 2^-16 of the largest, samp bit for
     bit (the plain version samples at the kernel's coordinates); the
     prefix's shapes take the tensor-core kernel (its warps a block
     printed), F = 60 the CUDA-core one;
 32. the training CLI with --dtype bf16 on the ladder and on the
     fused-prefix routes (one epoch of 20 steps at batch 64, twice from
     one seed: every launch per step on the bf16 instantiations and the
     bf16 block's passes, 9 transforms and 3 folds on the ladder, the
     visualization in f32, the same checkpoint bits); one bf16 step on
     each kernel route (ladder, per layer with dX and dCK, per layer with
     dX alone, fused prefix), card against CPU at phase 28's bounds;
 33. at batch 640: each bf16 kernel of phases 30-31 against its plain
     version, its bf16 library call (cuDNN's collapsed route: forward,
     dgrad, wgrad; the split prefix) and its bf16 bound, in event and
     device time (the block forward and dCK with their transform pass,
     the block dX alone on the folded cotangent), each bf16 pass beside
     them, and the whole bf16 block backward in one call beside cuDNN's
     bf16 dgrad and wgrad; the bf16 step on the default, ladder, per-layer and
     fused-prefix routes in one run (time, images/s, idle share, peak
     memory, each port kernel's device time; the fused prefix's per-quad
     d_coords twice);
 34. the 64px pyramid's kernel shapes against their plain versions: the
     refine trunk's per-layer upsample-conv at (256, 32, 32, 64) ->
     64x64x64, k5 (forward, dX, dCK; f32 and bf16, the bf16 forward on
     the TMA kernel), and the sampler forward on the augmentation's
     (128, 64, 64, 3) reals (f32 and bf16, rows and grid, bit for bit);
     each timed against its plain version, its library call and bound;
 35. cli.stack64_warmstart grafts phase 8's 32px G into a G64_stack, and
     the training CLI runs catgen's 64px workflow (G64_stack against D64,
     --augment --collapseDetect --weightsVisFreq 1 --profile; 2 epochs of
     5 steps at batch 64) on the default route and ROUTE64 (the base as
     the ladder, the refine per layer), f32 and bf16: the warm start
     picked up, every launch as designed, a completed run, the
     activation grids, the trace naming each kernel of the step, the
     sample CLI reading the checkpoint;
 36. one 64px step at batch 8, card against CPU, on both routes (G's
     gradients within G64_GRAD_REL); the 64px step at batch 256
     (bench.py's 64px configuration) in f32 and bf16 on both routes
     (median with min and max, images/s, idle share, peak memory, each
     port kernel's device time).
 37. the kernel shapes of the 16px models and G32up against their plain
     versions, f32 and bf16: the upsample-conv kernels at G16up's two
     stages and G32up's first (NEW_STAGES, B=640: every form, the
     repeats bit for bit, the forward, dX and dCK against float64, the
     bf16 passes, the bf16 forward's TMA box and the cp.async kernel for
     a misaligned x), the sampler at the 16px input ST, D32_st3's 8x8x64
     branches and the augmentation's coordinates (the kernel each takes),
     the ST-conv prefix at 16x16; each timed against its plain version,
     its library call and its bound; rows 4 and 6 at G64_stack's base
     stages (B=256) against cuDNN's collapsed route with the input
     transform and the BatchNorm sums, and dgrad + wgrad in one call;
 38. catgen's 16px workflow through the CLIs: cli.train_v --scale 16
     (V16), cli.pretrain_g --scale 16 on the default and ladder routes,
     cli.train --scale 16 (G16up against D32_st3 on the default, ladder
     and fused-prefix routes and against D16_st3 on the default route,
     f32 and bf16, 2 epochs of 5 steps at batch 64, augmented, a
     profiled epoch: every launch as designed, the trace's kernel names,
     the runs picking up V and the pretrained G, cli.sample reading each
     checkpoint); a 16px step at batch 8 card against CPU on the default,
     ladder, fused-prefix and per-layer routes (f32 within phase 9's
     bounds, bf16 within phase 28's); one step of every other registry
     model on the card; the 16px step at batch 640 timed in f32 and bf16
     on the default and ladder routes;
 39. cli.eval_quality on phase 8's checkpoint with phase 22's V, 1024
     samples against a 16384-image corpus, on the card and on the CPU:
     every report field equal within the CPU parity test's tolerances;
     cli.show_ckpt's output equal to a CPU process's;
 40. data parallelism (catgen_torch/dist) and the rest of the loader:
     (a) the native JPEG decoder builds and fills the cache where a C++
     compiler and jpeglib.h are present (decoder_used "native"), within
     catgen's mean-abs 4.0 of PIL, and a corrupt file is refused; (b) in a
     world of one NCCL rank on cuda:0 the DP GAN step (G32up-c against
     D32_st3, batch 640, augmented) on the default and ladder routes, f32
     and bf16, equals the plain step bit for bit, with the plain step's
     launches plus its all-reduces (dist.dp.all_reduces_per_gan_step);
     (c) two gloo ranks on the card: catgen's three dryrun_multichip
     configurations, 3 steps each, the state bit-equal across the ranks,
     and one f32 DP step at 2 x 320 against the single step at 640 within
     phase 9's bounds (on weights without a switch within rounding: PReLU
     slopes 1, ST heads of zero weights, D updated by SGD;
     ``dp_two_ranks``); (d) cli.train, cli.train_v and cli.pretrain_g
     through --devices 1 --coordinator --numProcesses 1 --processId 0,
     one epoch each, and --devices 2 refused on one card; (e) the world of
     one's DP step beside the plain step in time, f32 and bf16, default
     route (the cost of the reductions; a finding, no claim).

Each phase off the default route sets the selectors through
catgen_torch.kernels.config.using and restores them; phases 1-10 and
26-29 run the default route. From phase 5 on, everything runs in the numeric mode the
CLIs set (full f32, cuDNN deterministic); each train step is timed with
and without cuDNN's deterministic algorithms. It prints a JSON line describing the kernels, the card's
name and power limit, and as its last line {"ok": true, "device": {...}}.
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
# the d_coords kernel each shape takes (kernels.bilinear.dcoords_kind): the
# input ST per pixel, the branch shape staged, and a 32x32x64 image (256
# KB, over the shared memory of a block) per warp
DCOORDS_SHAPES = TRAIN_SHAPES + [(64, 32, 32, 64, 32, 32)]
DCOORDS_KINDS = ("per_pixel", "staged", "per_warp")
# the d_img kernel they take (kernels.bilinear.dimg_kind): the input ST's
# 3 channels per sample (a block of 8 slabs), the 64-channel images by the
# gather (output pixels bucketed by input pixel, each bin summed in order)
DIMG_KINDS = ("per_sample", "gather", "gather")
# a zoomed-in input ST: every output pixel within 0.1 of the centre, so
# the 1024 output pixels of a sample land on a few taps (phase 4)
ZOOM = 0.1
# the forward kernel the same shapes take (kernels.bilinear.forward_kind):
# the input ST per quad (its image in shared memory, four output pixels a
# thread), the branch shape staged; both give the plain version's bits
FORWARD_KINDS = ("per_quad", "staged", "per_value")
BIT_EXACT_FORWARDS = ("per_quad", "staged")
# the sampler kernels of a default-route train step by name, and their
# launches per step (phase 10's profiled step)
STEP_SAMPLER_KERNELS = {"sample_per_quad_staged": 3,
                        "sample_per_pixel_staged": 2, "dimg_per_sample": 1,
                        "dimg_gather": 2, "dcoords_per_pixel": 2,
                        "dcoords_staged": 2}
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


def device_ms(fn, calls: int = 0, warmup: int = 3) -> tuple:
    """(ms per call, names of the kernels, source) of ``fn``: the device
    time of every kernel it launches, from the profiler, over ``calls``
    calls after warm-up (with ``calls`` 0: at least 100, and at least 20
    ms of them by a CUDA-event estimate). Unlike an event pair this leaves
    out the host's work between launches. Once phase 7 has profiled the
    sampling pipeline, every later session of the process drops a few
    kernel records (1 to 6 of 100-1500 launches seen on the H100, more
    late in the run): a session counts if some kernel was seen for at
    least 90% of the calls, and each kernel adds its device time over its
    own count, times its launches per call. A session is asked up to three
    times, and then the time comes from CUDA events (source "events", no
    names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if calls <= 0:
        est = cuda_ms(fn, reps=3, inner=20, warmup=0)
        calls = min(5000, max(100, math.ceil(20.0 / max(est, 1e-4))))
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.count > 0]
        busy = sum(e.self_device_time_total for e in kernels)
        if busy > 0 and max(e.count for e in kernels) >= 0.9 * calls:
            per_call = sum(e.self_device_time_total / e.count
                           * round(e.count / calls) for e in kernels)
            return per_call / 1e3, [e.key for e in kernels], "profiler"
        print(f"  profiler session of {calls} calls rejected: device "
              f"kernels {[(e.key[:40], e.count) for e in kernels][:4]}")
    return cuda_ms(fn, inner=calls), [], "events"


# each sampler kernel's library call (one output of the backward)
SAMPLER_LIBRARY = {"fwd": "grid_sample",
                   "dcoords": "grid_sampler_2d_backward (grid output)",
                   "dimg": "grid_sampler_2d_backward (input output)"}


def sampler_device_line(key: str, layout: str, shape, kern, library,
                        card_name: str, elem: int = 4) -> tuple:
    """Prints a sampler kernel's device time (key: fwd, dcoords or dimg)
    beside its library call's (grid_sample, or grid_sampler_2d_backward
    with the one output the kernel computes) in the same run, and their
    ratio; returns (kernel ms, library ms). ``elem``: 4 for the f32
    kernels, 2 for the bf16 ones."""
    import torch
    from catgen_torch.kernels import bilinear

    k1, names, src1 = device_ms(kern)
    lib_ms, _, src_lib = device_ms(library)
    k2, _, src2 = device_ms(kern)
    k_ms = min(k1, k2)
    kind = {"fwd": bilinear.forward_kind, "dcoords": bilinear.dcoords_kind,
            "dimg": bilinear.dimg_kind}[key](
        *shape[1:4], torch.float32 if elem == 4 else torch.bfloat16)
    print(f"{key} {layout} {shape}: kernel {kind} "
          f"({names[0][:60] if names else '-'}) device {k_ms:.4f} ms, "
          f"{SAMPLER_LIBRARY[key]} device {lib_ms:.4f} ms, ratio "
          f"{k_ms / lib_ms:.3f}, bound "
          f"{sampler_bound(key, shape, elem)[0]:.4f} ms (sessions of >= 100 "
          f"calls and >= 20 ms, order kernel-library-kernel, best of the "
          f"two kernel readings; from {src1}/{src_lib}/{src2}); "
          f"{card_name}")
    return k_ms, lib_ms


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


# the numeric mode the CLIs set (catgen_torch/cli/common.py::resolve_device)
CLI_MODE = {"cudnn.allow_tf32": False, "cuda.matmul.allow_tf32": False,
            "cudnn.deterministic": True, "cudnn.benchmark": False}


def numeric_mode() -> dict:
    import torch

    b = torch.backends
    return {"cudnn.allow_tf32": b.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": b.cuda.matmul.allow_tf32,
            "cudnn.deterministic": b.cudnn.deterministic,
            "cudnn.benchmark": b.cudnn.benchmark}


def step_modes(fn, what: str, card_name: str) -> dict:
    """The train step ``fn`` timed (wall_ms, 12 steps) with cuDNN's
    deterministic algorithms, the CLIs' mode, and without, in that order;
    the mode it found is restored. step_ms and images_per_s are the
    deterministic reading, step_ms_nondeterministic the other."""
    import torch

    mode = torch.backends.cudnn.deterministic
    out = {}
    try:
        for deterministic in (True, False):
            torch.backends.cudnn.deterministic = deterministic
            med, lo, hi = wall_ms(fn, reps=12)
            ips = 2 * TRAIN_B / med * 1e3
            print(f"{what}, cudnn.deterministic={deterministic}: median "
                  f"{med:.3f} ms of 12 (min {lo:.3f}, max {hi:.3f}) = "
                  f"{ips:.1f} images/s (2 x batch per step, bench.py's "
                  f"accounting); {card_name}")
            if deterministic:
                out.update(step_ms=med, images_per_s=ips)
            else:
                out["step_ms_nondeterministic"] = med
    finally:
        torch.backends.cudnn.deterministic = mode
    print(f"{what}: cuDNN's deterministic algorithms cost "
          f"{out['step_ms'] - out['step_ms_nondeterministic']:+.3f} ms per "
          f"step (same run); {card_name}")
    return out


def cli_repeats(root: str) -> None:
    """The training CLI twice on the card from one seed, one epoch each on
    the default route, each started in the opposite numeric mode (TF32 on,
    cuDNN free to pick and autotune): the CLI must set TF32 off for cuDNN
    and matmuls and cuDNN deterministic without autotuning, and the two
    checkpoints must hold the same bits."""
    import numpy as np
    import torch
    from catgen_torch.cli import train as train_cli
    from catgen_torch.data.fixture import write_fixture_dataset

    corpus = write_fixture_dataset(os.path.join(root, "corpus"), n=256)
    args = list(TRAIN_ARGS[2:])                # no --fixture: one corpus
    args[args.index("--epochs") + 1] = "1"
    b = torch.backends
    leaves = []
    for run in range(2):
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = True
        b.cudnn.deterministic, b.cudnn.benchmark = False, True
        save = os.path.join(root, f"run{run}")
        train_cli.main(args + ["--dataset", corpus, "--device", "cuda",
                               "--save", save, "--seed", "5"])
        mode = numeric_mode()
        print(f"after training CLI run {run + 1}: {mode}")
        require(mode == CLI_MODE, f"the CLI left {mode}, not {CLI_MODE}")
        with np.load(os.path.join(save, "adversarial.ckpt")) as z:
            leaves.append({k: z[k] for k in z.files if k != "__meta__"})
    a, c = leaves
    differ = sorted(k for k in a if k not in c or a[k].dtype != c[k].dtype
                    or a[k].shape != c[k].shape
                    or a[k].tobytes() != c[k].tobytes())
    print(f"two same-seed training CLI runs (one epoch, default route): "
          f"{len(a)} checkpoint arrays, {len(differ)} differ in any bit"
          f"{': ' + ', '.join(differ[:5]) if differ else ''}")
    require(a.keys() == c.keys() and not differ,
            "same-seed CLI runs wrote different checkpoints")


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
    tensor_core_check(path)


# the tensor-core kernels (mangled-name stem), and per element type their
# instantiations and tensor-core instruction: f32 runs 3xTF32 (TF32
# products), bf16 one BF16 product (the _bf16 kernels). dCK: fold x
# transform x 16-byte copies in f32 (mma.sync: HMMA), 16-byte copies in
# bf16 (wgmma: HGMMA; the bf16 block's transform and fold are passes of
# their own); dX: fold x transform x 16-byte copies in f32, transform x
# 16-byte copies in bf16 (it reads the fold pass's output; wgmma: HGMMA);
# the forward: transform x stats x 16-byte copies in f32, stats x 16-byte
# copies in bf16 and stats in the TMA kernel (wgmma: HGMMA); the bf16
# ST-conv on the tensor cores: C = 1..4 x 4 or 16 warps (mma.sync: HMMA)
TENSOR_CORE_KERNELS = {
    "upsample_conv_dck": {"TF32": (8, "HMMA"), "BF16": (2, "HGMMA")},
    "upsample_conv_fwd": {"TF32": (8, "HGMMA"), "BF16": (6, "HGMMA")},
    "upsample_conv_dx": {"TF32": (8, "HGMMA"), "BF16": (4, "HGMMA")},
    "st_conv_bf16_mma": {"BF16": (8, "HMMA")}}


def tensor_core_check(path) -> None:
    """Requires the machine code (cuobjdump -sass) of every instantiation
    of the dCK, dX and forward upsample-conv kernels and of the bf16
    ST-conv's tensor-core kernel to hold tensor-core products of its
    element type and design (HMMA from mma.sync, HGMMA from wgmma; TF32
    for the f32 kernels, BF16 for the bf16 ones), and prints their count
    and the first one of each instantiation."""
    from torch.utils import cpp_extension

    tool = shutil.which("cuobjdump") or os.path.join(
        cpp_extension.CUDA_HOME or "", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    found = {(stem, t): 0 for stem, kinds in TENSOR_CORE_KERNELS.items()
             for t in kinds}
    for block in sass.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        stem = next((k for k in TENSOR_CORE_KERNELS if k in name), None)
        if stem is None:
            continue
        kinds = TENSOR_CORE_KERNELS[stem]
        kind = (next(iter(kinds)) if len(kinds) == 1
                else "BF16" if f"{stem}_bf16" in name else "TF32")
        op = TENSOR_CORE_KERNELS[stem][kind][1]
        mma = [ln.strip() for ln in block.splitlines()
               if op in ln and kind in ln]
        print(f"SASS {name}: {len(mma)} {kind} {op} instructions, "
              f"e.g. {mma[0] if mma else 'none'}")
        require(mma, f"{name} has no {kind} {op} instruction")
        found[(stem, kind)] += 1
    for (stem, kind), n in found.items():
        want, op = TENSOR_CORE_KERNELS[stem][kind]
        print(f"{stem} ({kind}): {n} instantiations, each with {kind} {op} "
              f"instructions")
        require(n == want, f"{n} {kind} {stem} instantiations in the "
                           f"SASS, not {want}")


def sampler_inputs(shape, seed):
    import torch

    n, h, w, c, ho, wo = shape
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand((n, h, w, c), generator=gen)
    rows = torch.rand((n, 2, ho * wo), generator=gen) * 2.4 - 1.2
    return img.cuda(), rows.cuda(), (ho, wo)


def forward_kinds(shapes) -> None:
    """Prints the forward kernel each shape takes, and requires the
    designed one (FORWARD_KINDS, by the image's channel count and size)."""
    from catgen_torch.kernels import bilinear

    for shape in shapes:
        kind = bilinear.forward_kind(*shape[1:4])
        want = dict(zip((s[1:4] for s in DCOORDS_SHAPES),
                        FORWARD_KINDS))[shape[1:4]]
        print(f"forward kernel at {shape}: {kind} (designed: {want})")
        require(kind == want, f"the forward at {shape} took {kind}")


def misaligned(t):
    """A copy of ``t`` whose data starts 4 bytes past a 16-byte boundary:
    the staged kernels need 16-byte aligned arrays, so it takes the
    per-value forward (per-warp d_coords), or the per-pixel forward for C <
    32."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def kernel_vs_plain() -> float:
    """The forward kernel against its plain version at the sampling path's
    shapes: within KERNEL_TOL, and bit for bit where the per-quad or the
    staged kernel runs (both shapes), which must also give the bits of
    the kernel a misaligned copy of the image takes (per pixel, per
    value)."""
    import torch
    from catgen_torch.kernels import bilinear

    forward_kinds(SAMPLER_SHAPES)
    worst = 0.0
    for i, shape in enumerate(SAMPLER_SHAPES):
        img, rows, out_hw = sampler_inputs(shape, seed=10 + i)
        got = bilinear.launch(img, rows, out_hw)
        other = bilinear.launch(misaligned(img), rows, out_hw)
        torch.cuda.synchronize()
        want = bilinear.bilinear_sample_rows_plain(img, rows, out_hw)
        require(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
        err = (got - want).abs().max().item()
        kind = bilinear.forward_kind(*shape[1:4])
        exact = kind in BIT_EXACT_FORWARDS
        same = torch.equal(got, want) and torch.equal(got, other)
        print(f"{shape}: max_abs_err {err:.3e} (tolerance {KERNEL_TOL}); "
              f"bits equal to the plain version's and to the kernel's of a "
              f"misaligned image: {same}{f' (required: {kind})' if exact else ''}")
        require(err <= KERNEL_TOL, f"kernel disagrees with plain at {shape}")
        require(same or not exact, f"the {kind} forward's bits at {shape}")
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
    from catgen_torch.kernels import (bilinear, bilinear_grid,
                                      fused_upsample_conv, st_conv)

    bilinear.reset_launches()
    st_conv.LAUNCHES = st_conv.BF16_LAUNCHES = 0
    bilinear_grid.reset_launches()
    fused_upsample_conv.reset_launches()


# D's routes off the default (phases 17-20): catgen's selectors
FUSED = dict(st_conv_impl="fused")
GRID = {v: dict(sampler_impl="mxu", sampler_kernel=v)
        for v in ("v1", "v2", "v3")}


def sampler_counts() -> dict:
    """Launches of D's kernels since the last reset: the v4 sampler (rows),
    the ST-conv kernel, the grid sampler and its generations' names."""
    from catgen_torch.kernels import bilinear, bilinear_grid, st_conv

    return {"fwd": bilinear.LAUNCHES, "dcoords": bilinear.DCOORDS_LAUNCHES,
            "dimg": bilinear.DIMG_LAUNCHES, "st_conv": st_conv.LAUNCHES,
            **bilinear_grid.launches()}


def expected_sampler(route, steps: int, d_evals: int) -> dict:
    """D's kernel launches the design gives for ``steps`` train steps with
    augmentation and ``d_evals`` eval-mode D batches on ``route``. A D
    forward samples twice (the input ST; the three branch STs stacked),
    and a step runs D forward in both phases: with the augmentation 5
    forwards; d_coords at all 4 sites; d_img at 3 (not the D phase's input
    ST, which samples data). The fused prefix takes the input ST's
    forward; its backward is the same d_coords and d_img. The grid route
    takes every site, the augmentation as bilinear_sample (no
    generation's name)."""
    from catgen_torch.kernels import bilinear_grid

    route = route or {}
    want = {"fwd": 0, "dcoords": 4 * steps, "dimg": 3 * steps, "st_conv": 0,
            **dict.fromkeys(bilinear_grid.COUNTERS, 0)}
    gen = route.get("sampler_kernel", "v4")
    if route.get("sampler_impl", "auto") != "xla" and gen == "v4":
        if route.get("st_conv_impl") == "fused":
            want.update(fwd=3 * steps + d_evals, st_conv=2 * steps + d_evals)
        else:
            want.update(fwd=5 * steps + 2 * d_evals)
        return want
    want.update(dcoords=0, dimg=0, LAUNCHES=5 * steps + 2 * d_evals,
                DCOORDS_LAUNCHES=4 * steps, DIMG_LAUNCHES=3 * steps)
    if route.get("sampler_impl", "auto") != "xla":
        want[f"{gen.upper()}_LAUNCHES"] = 4 * steps + 2 * d_evals
    return want


def upsample_counts() -> dict:
    """Launches of each upsample-conv kernel since the last reset."""
    from catgen_torch.kernels import fused_upsample_conv

    return fused_upsample_conv.launches()


def expected_upsample(route, steps: int, g_evals: int,
                      stages: int = 3) -> dict:
    """The upsample-conv launches the design gives for ``steps`` train steps
    and ``g_evals`` eval-mode G batches on ``route`` (None: the default,
    collapsed route, which launches none). A step runs G three times per
    stage count: forward in the D phase (no gradient) and forward and
    backward in the G phase; G32up-c and G32up-b have three upsample-conv
    stages, G16up and G32up ``stages`` = 2."""
    from catgen_torch.kernels import fused_upsample_conv

    want = dict.fromkeys(fused_upsample_conv.COUNTERS, 0)
    if route is None or route.get("upsample_impl") != "pallas":
        return want
    if route["fused_ladder"]:
        want["BLOCK_LAUNCHES"] = stages * (2 * steps + g_evals)
        if route["ladder_bwd"] == "pallas":
            want["BLOCK_DX_LAUNCHES"] = want["BLOCK_DCK_LAUNCHES"] = \
                stages * steps
    else:
        want["LAUNCHES"] = stages * (2 * steps + g_evals)
        if route["upsample_bwd"] in ("pallas", "hybrid"):
            want["DX_LAUNCHES"] = stages * steps
        if route["upsample_bwd"] == "pallas":
            want["DCK_LAUNCHES"] = stages * steps
    return want


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
    require(upsample_counts() == expected_upsample(None, 0, 0),
            f"upsample-conv kernels launched on the default route: "
            f"{upsample_counts()}")
    launches = counts[0]
    expected = 2 * COUNT // 256
    print(f"sampler kernel launches during the CLI run: {launches} "
          f"(expected {expected}: 2 per D batch x {COUNT // 256} batches)")
    require(launches == expected, "the path did not go through the kernel")
    require(counts[1:] == (0, 0), f"backward kernels launched while "
            f"sampling: {counts}")
    require(sampler_counts() == expected_sampler(None, 0, COUNT // 256),
            f"D's other kernels launched on the default route: "
            f"{sampler_counts()}")
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
    return counts, result


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
        if "sample_per" in e.key:
            print(f"sampler kernel in the pipeline: {e.key[:60]} "
                  f"{us / e.count / 1e3:.4f} ms device time per launch "
                  f"(x{e.count}); {card_name}")
    return out


def dcoords_kinds() -> None:
    """Prints the d_coords and d_img kernels each shape of DCOORDS_SHAPES
    takes, and requires the designed ones."""
    from catgen_torch.kernels import bilinear

    for shape, want, want_img in zip(DCOORDS_SHAPES, DCOORDS_KINDS,
                                     DIMG_KINDS):
        kind = bilinear.dcoords_kind(*shape[1:4])
        kind_img = bilinear.dimg_kind(*shape[1:4])
        print(f"d_coords kernel at {shape}: {kind} (designed: {want}); "
              f"d_img kernel: {kind_img} (designed: {want_img})")
        require(kind == want, f"d_coords at {shape} took {kind}")
        require(kind_img == want_img, f"d_img at {shape} took {kind_img}")


def backward_vs_plain() -> dict:
    """The d_img and d_coords kernels against the plain version's autograd
    at the training shapes, at a shape of the per-warp d_coords kernel and
    at the input ST's shape zoomed in (ZOOM: the per-sample d_img kernel's
    lanes collide on a few taps); repeats bit-identical; a sampled image
    that needs no gradient launches no d_img kernel. Returns the max abs
    errors {'dimg': ..., 'dcoords': ...}."""
    import torch
    from catgen_torch.kernels import bilinear

    dcoords_kinds()
    worst = {"dimg": 0.0, "dcoords": 0.0}
    cases = [(shape, 1.0) for shape in DCOORDS_SHAPES]
    cases.append((TRAIN_SHAPES[0], ZOOM))
    for i, (shape, zoom) in enumerate(cases):
        img, rows, out_hw = sampler_inputs(shape, seed=30 + i)
        rows = rows * zoom
        if zoom != 1.0:
            h, w = shape[1:3]
            tap = (torch.floor((rows[0, 0] + 1) * 0.5 * (h - 1)) * w
                   + torch.floor((rows[0, 1] + 1) * 0.5 * (w - 1)))
            print(f"{shape} zoomed in (coordinates x {ZOOM}): sample 0's "
                  f"{out_hw[0] * out_hw[1]} output pixels have their first "
                  f"tap at {torch.unique(tap).numel()} input pixels")
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
            print(f"{shape}{' zoomed' if zoom != 1.0 else ''} {name}: "
                  f"max_abs_err {err:.3e} (tolerance "
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


def train_on_card(save: str, route=None, n_epochs: int = 2) -> tuple:
    """The training CLI on the card, on the default route or on ``route``
    (kernel selectors, set around the run and restored), for ``n_epochs``
    epochs of 20 steps; returns D's kernel launch counts (see
    ``sampler_counts``), the upsample-conv launch counts and the number of
    steps."""
    from catgen_torch.cli import sample as sample_cli
    from catgen_torch.cli import train as train_cli
    from catgen_torch.kernels import config as upconfig

    args = list(TRAIN_ARGS)
    args[args.index("--epochs") + 1] = str(n_epochs)
    reset_counts()
    with upconfig.using(**(route or {})):
        harness = train_cli.main(args + ["--device", "cuda", "--save", save])
    counts, up = sampler_counts(), upsample_counts()
    steps, vizzes = harness.state.step, n_epochs
    # each visualization runs D twice (samples, probes) and G once in eval
    expected = expected_sampler(route, steps, 2 * vizzes)
    shown = {k: v for k, v in counts.items() if v or expected[k]}
    print(f"training CLI: {steps} steps, {vizzes} visualizations; D's "
          f"kernel launches {shown}, expected "
          f"{ {k: expected[k] for k in shown} }")
    require(counts == expected, "the training path's kernel launches")
    want_up = expected_upsample(route, steps, vizzes)
    print(f"upsample-conv launches {up}, expected {want_up}")
    require(up == want_up, "the training path's upsample-conv launches")
    with open(os.path.join(save, "train_metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    epochs = [e for e in events if e["event"] == "epoch"]
    for e in epochs:
        print(f"epoch {e['epoch']}: loss_d {e['loss_d']:.5f} loss_g "
              f"{e['loss_g']:.5f} acc_d {e['acc_d']:.4f} "
              f"{e['imgs_per_sec']} imgs/s (CLI clock, first epoch "
              f"includes warm-up)")
    require(len(epochs) == vizzes, f"{len(epochs)} epoch lines, not "
            f"{vizzes}")
    require(all(math.isfinite(e[k]) for e in epochs
                for k in ("loss_d", "loss_g")), "non-finite losses")
    for epoch in range(1, vizzes + 1):
        for d in ("images", "images_good", "images_bad", "images_real"):
            path = os.path.join(save, d, f"epoch_{epoch:06d}.png")
            require(os.path.getsize(path) > 0, f"missing grid {path}")
    ckpt = os.path.join(save, "adversarial.ckpt")
    require(os.path.getsize(ckpt) > 0, "no checkpoint written")
    with upconfig.using(**(route or {})):
        runs = sample_cli.main(["--save", save, "--count", "256",
                                "--device", "cuda", "--neighbours"])
    check_finite(runs[0])
    require(runs[0]["images"].is_cuda, "sampled images not on the card")
    print(f"sample CLI read {ckpt} on the card: 256 images, D scores "
          f"{runs[0]['scores'].min().item():.4f}..."
          f"{runs[0]['scores'].max().item():.4f}")
    return counts, up, steps


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


def step_card_vs_cpu(route=None, pair=None, image=(32, 32, 3),
                     expected=None, g_rel: float = GRAD_REL) -> dict:
    """One train step at batch 8 with augmentation on the CPU and on the
    card, from the same weights and the same draws: losses, gradients and
    parameters after the step. With ``route`` (upsample-conv selectors)
    both run that route: the card its kernels, the CPU their plain
    versions. ``pair`` makes (G, D) (default: the flagship pair, seeded)
    for ``image``; ``expected(route)`` gives the card's launches
    (``bf16_route_counts``) for one step, where the flagship's design does
    not; ``g_rel`` bounds G's gradients in place of GRAD_REL."""
    import copy

    import torch
    from catgen_torch import optim
    from catgen_torch.core.random import Draws
    from catgen_torch.kernels import config as upconfig
    from catgen_torch.train import gan

    config = gan.GanConfig(batch_size=8, augment=True)
    g, d = pair() if pair else seeded_pair(3, G_GAIN, D_GAIN)
    reals = torch.rand((4, *image),
                       generator=torch.Generator().manual_seed(4))
    out, d_counts = {}, {}
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
        reset_counts()
        # cuDNN's default backward algorithms sum in a different order
        # from run to run, and that noise reaches G's shared PReLU slopes
        # (a sum that cancels) at up to ~1.4e-3 of the leaf: compare with
        # its deterministic algorithms; phase 10 reports the noise
        mode = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = dev == "cuda"
        try:
            with upconfig.using(**(route or {})):
                m = gan.make_train_step(gd, dd, config)(
                    state, reals.to(dev), draws)
        finally:
            optim.clamp_and_penalize = real_cap
            torch.backends.cudnn.deterministic = mode
        if dev == "cpu":
            recorded = draws
        elif expected:
            d_counts = bf16_route_counts()
            print(f"launches on the card: "
                  f"{ {k: v for k, v in d_counts.items() if v} }")
            require(d_counts == expected(route), "the step's launches")
        else:
            up, d_counts = upsample_counts(), sampler_counts()
            print(f"launches on the card: upsample-conv {up}; D's kernels "
                  f"{ {k: v for k, v in d_counts.items() if v} }")
            require(up == expected_upsample(route, 1, 0),
                    "the step's upsample-conv launches")
            require(d_counts == expected_sampler(route, 1, 0),
                    f"the step's D kernel launches, expected "
                    f"{expected_sampler(route, 1, 0)}")
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
    for phase_name, a, b, leaf_rel in zip("DG", gg, gc, (GRAD_REL, g_rel)):
        top = max(v.abs().max().item() for v in b.values())
        rel = []
        for k in b:
            err = (a[k] - b[k]).abs().max().item()
            bound = leaf_rel * b[k].abs().max().item() + GRAD_FLOOR * top
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
          f"largest (tolerance {GRAD_REL}, G's {g_rel}, + {GRAD_FLOOR} of "
          f"the update's largest)")
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
    return {"grad_rel": worst_grad, "param_abs": worst,
            "launches": d_counts}


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

    out.update(step_modes(lambda: step(state, reals, draws),
                          f"train step, batch {TRAIN_B}, augment",
                          card_name))
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
    mode = torch.backends.cudnn.deterministic
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
    torch.backends.cudnn.deterministic = mode

    # the sampler kernels against their plain versions and against
    # PyTorch's grid_sample (align_corners, border padding; NCHW input, as
    # that call takes it), forward and backward, at the training shapes
    import torch.nn.functional as F

    for key in ("fwd", "dcoords", "dimg"):
        out[key], out[f"{key}_plain"], out[f"{key}_library"] = [], [], []
    for i, shape in enumerate(TRAIN_SHAPES):
        img, rows, out_hw = sampler_inputs(shape, seed=60 + i)
        gcot = torch.rand((shape[0], *out_hw, shape[3]), device=device)
        inp = img.permute(0, 3, 1, 2).contiguous()
        gn = gcot.permute(0, 3, 1, 2).contiguous()
        grid = torch.stack([rows[:, 1], rows[:, 0]], dim=-1).reshape(
            shape[0], *out_hw, 2).contiguous()

        def grid_bwd(mask, gn=gn, inp=inp, grid=grid):
            # (g, input, grid, bilinear, border, align_corners, outputs)
            return torch.ops.aten.grid_sampler_2d_backward(
                gn, inp, grid, 0, 1, True, mask)

        pairs = {
            "fwd": (lambda: bilinear.launch(img, rows, out_hw),
                    lambda: bilinear.bilinear_sample_rows_plain(
                        img, rows, out_hw),
                    lambda: F.grid_sample(inp, grid, mode="bilinear",
                                          padding_mode="border",
                                          align_corners=True)),
            "dcoords": (lambda: bilinear.launch_dcoords(img, rows, gcot,
                                                        out_hw),
                        lambda: bilinear.bilinear_sample_rows_backward_plain(
                            img, rows, gcot, out_hw, need_img=False),
                        lambda: grid_bwd([False, True])),
            "dimg": (lambda: bilinear.launch_dimg(img, rows, gcot, out_hw),
                     lambda: bilinear.bilinear_sample_rows_backward_plain(
                         img, rows, gcot, out_hw, need_coords=False),
                     lambda: grid_bwd([True, False])),
        }
        for key, (kern, _, library) in pairs.items():
            out.setdefault(f"{key}_device", []).append(sampler_device_line(
                key, "rows", shape, kern, library, card_name))
        for name, (kern, plain, library) in pairs.items():
            p1, k1 = cuda_ms(plain, inner=10), cuda_ms(kern, inner=10)
            k2, p2 = cuda_ms(kern, inner=10), cuda_ms(plain, inner=10)
            lib = cuda_ms(library, inner=10)
            out[name].append(min(k1, k2))
            out[f"{name}_plain"].append(min(p1, p2))
            out[f"{name}_library"].append(lib)
            print(f"sampler {name} {shape}: kernel {min(k1, k2):.4f} ms, "
                  f"plain {min(p1, p2):.4f} ms, grid_sample {lib:.4f} ms "
                  f"(CUDA events, median of 20 timings of 10 back-to-back "
                  f"calls, order plain-kernel-kernel-plain-library, best "
                  f"of the two medians); {card_name}")

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
        if "sample_per" in e.key or "dcoords" in e.key or "dimg" in e.key:
            print(f"sampler kernel in the step: {e.key[:70]} "
                  f"{us / e.count / 1e3:.4f} ms device time per launch "
                  f"(x{e.count}); {card_name}")
    # the kernels the step's sampler launches by shape: 3 forwards at C=3
    # (the input ST on two batches, the augmentation), 2 at the branch
    # shape; d_img once at C=3 (G phase) and twice at the branch shape
    for name, designed in STEP_SAMPLER_KERNELS.items():
        seen = sum(e.count for e, _ in kernels if name + "<" in e.key)
        print(f"{name}: {seen} launches in the profiled step (designed "
              f"{designed}; the profiler may drop a record)")
    return out


# ---------------------------------------------------------------------------
# G's upsample-conv stages on the kernel route (phases 11-16)
# ---------------------------------------------------------------------------

F32_FLOPS = 67e12          # H100 SXM: f32 outside the tensor cores
TF32_FLOPS = 495e12        # H100 SXM: TF32 on the tensor cores, dense
HBM_BYTES = 3.35e12        # H100 SXM: HBM3 bytes per second
G_STAGES = [               # G32up-c's upsample-convs: (Cin, Cout, k, H=W)
    (512, 512, 3, 4), (512, 256, 3, 8), (256, 128, 5, 16)]
# kernel against plain: y and dx are sums of at most 4 * 4 * 512 products,
# summed in another order (1e-5 of the largest plain value); the stats,
# dweight, dbias, dscale, dshift and dalpha are sums over every output
# pixel, up to 640 * 32 * 32 = 655,360 terms (1e-4)
UP_TIGHT, UP_LOOSE = 1e-5, 1e-4
LADDER = dict(upsample_impl="pallas", fused_ladder=True, ladder_bwd="pallas")
LIBRARY_CALL = {"fwd": "forward", "block": "forward", "dx": "dgrad",
                "block_dx": "dgrad", "dck": "wgrad", "block_dck": "wgrad",
                "block_sums": "forward with the input transform and the "
                              "BN sums",
                "block_backward": "dgrad + wgrad in one call"}
PER_LAYER = dict(upsample_impl="pallas", fused_ladder=False,
                 upsample_bwd="pallas")
UP_KERNELS = (   # key, name, counter, TPU kernel, CUDA source
    ("fwd", "upsample2_conv_fused", "LAUNCHES",
     "catgen/kernels/pallas_upsample_conv.py:193", "upsample_conv.cu"),
    ("block", "upsample2_conv_block_fused", "BLOCK_LAUNCHES",
     "catgen/kernels/pallas_upsample_conv.py:332", "upsample_conv.cu"),
    ("dx", "upsample2_conv_backward_dx", "DX_LAUNCHES",
     "catgen/kernels/pallas_upsample_conv_bwd.py:105",
     "upsample_conv_bwd.cu"),
    ("dck", "upsample2_conv_backward_dck", "DCK_LAUNCHES",
     "catgen/kernels/pallas_upsample_conv_bwd.py:105", "upsample_conv_bwd.cu"),
    ("block_dx", "fused_block_backward_dx", "BLOCK_DX_LAUNCHES",
     "catgen/kernels/pallas_upsample_conv_bwd.py:343", "upsample_conv_bwd.cu"),
    ("block_dck", "fused_block_backward_dck", "BLOCK_DCK_LAUNCHES",
     "catgen/kernels/pallas_upsample_conv_bwd.py:343", "upsample_conv_bwd.cu"),
)


def bound(ops: float, nbytes: float) -> tuple:
    """(least ms, what bounds it): the larger of the f32 operations over
    the card's f32 rate and the bytes over its memory rate."""
    t_ops, t_bytes = ops / F32_FLOPS, nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound_3xtf32(flops: float, nbytes: float) -> tuple:
    """The bound of an f32 product run as 3xTF32 on the tensor cores: three
    TF32 products per f32 product, against the bytes."""
    t_ops, t_bytes = 3 * flops / TF32_FLOPS, nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sampler_bound(key: str, shape, elem: int = 4) -> tuple:
    """Bound of a sampler kernel at (N, H, W, C, Ho, Wo) with elements of
    ``elem`` bytes (4: f32, 2: bf16): each input read once, each output
    written once, ~8-12 flops per sampled value."""
    n, h, w, c, ho, wo = shape
    img, rows, sampled = n * h * w * c * elem, n * 2 * ho * wo * elem, \
        n * ho * wo * c * elem
    nbytes = {"fwd": img + rows + sampled,
              "dcoords": img + rows + sampled + rows,
              "dimg": rows + sampled + img}[key]
    ops = {"fwd": 8, "dcoords": 12, "dimg": 8}[key] * sampled / 4
    return bound(ops, nbytes)


def stage_shape(i: int, n: int) -> tuple:
    cin, cout, k, hw = G_STAGES[i]
    return (n, hw, hw, cin, cout, k)


def upsample_inputs(shape, seed: int, bf16: bool = False) -> dict:
    """One upsample-conv stage's operands on the card from ``seed``; with
    ``bf16`` every operand rounded to bf16 but the stats cotangents (gs1,
    gs2), which the ladder passes in f32."""
    import torch

    n, h, w, cin, cout, k = shape
    gen = torch.Generator("cuda").manual_seed(seed)

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=gen, device="cuda") * scale

    def rand(*size, scale=1.0, low=0.0):
        return torch.rand(size, generator=gen, device="cuda") * scale + low

    v = dict(x=randn(n, h, w, cin),
             weight=randn(cout, cin, k, k, scale=1 / math.sqrt(cin * k * k)),
             bias=randn(cout, scale=0.1), scale=rand(cin, low=0.5),
             shift=randn(cin, scale=0.3), alpha=rand(1, scale=0.5),
             alpha_c=rand(cin, scale=0.5), prelu_c=rand(cout, scale=0.5),
             gy=randn(n, 2 * h, 2 * w, cout), gs1=randn(cout, scale=0.01),
             gs2=randn(cout, scale=0.01))
    return {key: t.bfloat16() if bf16 and key not in ("gs1", "gs2") else t
            for key, t in v.items()}


def agrees(got, want, loose: bool = False) -> tuple:
    """(ok, largest absolute error, largest |want|, detail): a bf16 output
    within BF16_ULPS units in the last place of ``want`` plus BF16_FLOOR
    of its largest value (f32 sums of another order, rounded once), or
    BF16_SUM_FLOOR for a ``loose`` one (a sum over every pixel of the
    batch, phase 30); an f32 output within UP_TIGHT of the largest,
    UP_LOOSE for a ``loose`` one."""
    import torch

    err = (got.float() - want.float()).abs()
    top = max(want.float().abs().max().item(), 1e-6)
    if want.dtype == torch.bfloat16:
        floor = BF16_SUM_FLOOR if loose else BF16_FLOOR
        ok = bool((err <= BF16_ULPS * bf16_spacing(want) + floor * top).all())
        nonzero = want != 0
        units = ((err / bf16_spacing(want))[nonzero].max().item()
                 if bool(nonzero.any()) else 0.0)
        detail = (f"max {units:.2f} units in the last place of a nonzero "
                  f"value; within {BF16_ULPS} unit + {floor:g} x max "
                  f"{top:.4g}")
    else:
        rel = UP_LOOSE if loose else UP_TIGHT
        ok = err.max().item() <= rel * top
        detail = f"within {rel:g} x max {top:.4g}"
    return ok, err.max().item(), top, detail


def output_check(tag: str, got, again, want, loose: bool = False) -> tuple:
    """One kernel output against its plain version's (``agrees``), the
    repeat bit-identical. Returns the largest absolute error and its ratio
    to the largest plain value."""
    import torch

    require(got.dtype == want.dtype and got.shape == want.shape,
            f"{tag}: {got.dtype} {tuple(got.shape)} against "
            f"{want.dtype} {tuple(want.shape)}")
    ok, err, top, detail = agrees(got, want, loose)
    same = torch.equal(got, again)
    print(f"{tag}: max_abs_err {err:.3e}, {detail} |plain|: {ok}; repeat "
          f"bit-identical: {same}")
    require(ok, f"{tag} disagrees with its plain version")
    require(same, f"{tag} is not deterministic")
    return err, err / top


def passes_vs_plain(shapes=None) -> dict:
    """Phase 30: the bf16 block's passes against their plain versions at
    ``shapes`` (default ``g32up_c_shapes``; phase 37: NEW_STAGES): the
    transform's xn (``block_input``, a shared and a
    per-channel slope) and the fold's g (``block_fold``) bit for bit, the
    fold's dbias (an f32 sum over the batch in another order) within
    UP_LOOSE of its largest; repeats bit for bit. Returns each output's
    largest absolute error."""
    import torch
    from catgen_torch.kernels import fused_upsample_conv as fuc

    worst = {"transform": 0.0, "fold": 0.0, "fold_dbias": 0.0}
    for s, shape in enumerate(shapes or g32up_c_shapes()):
        v = upsample_inputs(shape, 320 + s, bf16=True)
        x, sc, sh, gy = v["x"], v["scale"], v["shift"], v["gy"]
        for alpha in ("alpha", "alpha_c"):
            got, again = (fuc.block_input_pass(x, sc, sh, v[alpha]),
                          fuc.block_input_pass(x, sc, sh, v[alpha]))
            torch.cuda.synchronize()
            want = fuc.block_input(x, sc, sh, v[alpha])
            err = (got.float() - want.float()).abs().max().item()
            same, rep = torch.equal(got, want), torch.equal(got, again)
            print(f"{shape} bf16 transform pass ({alpha}) xn: max_abs_err "
                  f"{err:.3e}, bit for bit: {same}; repeat bit-identical: "
                  f"{rep}")
            require(same and rep, f"the transform pass at {shape}")
            worst["transform"] = max(worst["transform"], err)
        y = fuc.block_plain(x, v["weight"], v["bias"], sc, sh, v["alpha"])
        (gf, db), (gf2, db2) = (fuc.block_fold_pass(y, gy, v["gs1"],
                                                    v["gs2"])
                                for _ in range(2))
        torch.cuda.synchronize()
        want_gf, want_db = fuc.block_fold(y, gy, v["gs1"], v["gs2"])
        err = (gf.float() - want_gf.float()).abs().max().item()
        same = torch.equal(gf, want_gf)
        rep = torch.equal(gf, gf2) and torch.equal(db, db2)
        print(f"{shape} bf16 fold pass g: max_abs_err {err:.3e}, bit for "
              f"bit: {same}; repeat bit-identical (g, dbias): {rep}")
        require(same and rep, f"the fold pass at {shape}")
        worst["fold"] = max(worst["fold"], err)
        db_err, _ = output_check(f"{shape} bf16 fold pass dbias", db, db2,
                                 want_db, loose=True)
        worst["fold_dbias"] = max(worst["fold_dbias"], db_err)
        del v, y, gf, gf2, want_gf
        torch.cuda.empty_cache()
    return worst


def g32up_c_shapes() -> list:
    """G32up-c's three stage shapes at N=640 and stage 3 at N=320 (the D
    phase's half batch)."""
    return ([stage_shape(i, TRAIN_B) for i in range(3)]
            + [stage_shape(2, TRAIN_B // 2)])


def upsample_vs_plain(bf16: bool = False, shapes=None) -> dict:
    """Each upsample-conv kernel against its plain version, in f32 (phase
    11) or in bf16 (phase 30), at ``shapes`` (default ``g32up_c_shapes``;
    phase 37: NEW_STAGES): the forward
    without a PReLU (the per-layer route's), with a scalar and with a
    per-channel slope; the block with and without the stats; (dx,
    dweight, dbias) of the per-layer backward; dweight of the dCK
    kernel's two other variants (the routes run the fold with the
    transform, and neither): the fold alone, the transform alone; the
    block backward's six outputs. Every kernel runs twice; the repeats
    must be bit-identical (``output_check``; the sums over the batch are
    ``loose``). Returns the largest absolute error of each kernel and,
    under "<key>_rel", the largest error over the largest plain value of
    its output."""
    import torch
    from catgen_torch.kernels import fused_upsample_conv as fuc

    worst = {key: 0.0 for key, *_ in UP_KERNELS}
    worst.update({f"{key}_rel": 0.0 for key, *_ in UP_KERNELS})
    for s, shape in enumerate(shapes or g32up_c_shapes()):
        v = upsample_inputs(shape, (300 if bf16 else 70) + s, bf16)
        x, w, b, gy = v["x"], v["weight"], v["bias"], v["gy"]
        sc, sh, al = v["scale"], v["shift"], v["alpha"]
        k = shape[5]
        gs = torch.stack([v["gs1"], v["gs2"]])
        ale = al.expand(shape[3]).contiguous()
        y = fuc.block_plain(x, w, b, sc, sh, al)
        args = (x, sc, sh, al, w, y, gy, v["gs1"], v["gs2"])
        g = fuc._fold(y, gy, v["gs1"], v["gs2"])

        def dweight(dck):
            return fuc.dweight_from_dck(dck, k, k).to(w.dtype)

        def dweight_plain(xn, g_):
            return dweight(fuc._kernel_vjp(xn, w, g_.to(x.dtype),
                                           need_x=False)[1])

        groups = [   # (keys, names, kernel, plain)
            ("fwd", ("y",), lambda: (fuc.upsample2_conv_fused(x, w, b),),
             lambda: (fuc.block_plain(x, w, b),)),
            *(("fwd", (f"y (PReLU {a})",),
               lambda a=a: (fuc.upsample2_conv_fused(x, w, b, v[a]),),
               lambda a=a: (fuc.block_plain(x, w, b, prelu_alpha=v[a]),))
              for a in ("alpha", "prelu_c")),
            ("block", ("y", "s1", "s2"),
             lambda: fuc.upsample2_conv_block_fused(x, w, b, sc, sh,
                                                    v["alpha_c"]),
             lambda: fuc.block_plain(x, w, b, sc, sh, v["alpha_c"],
                                     with_stats=True)),
            ("block", ("y (no stats)",),
             lambda: (fuc.upsample2_conv_block_fused(
                 x, w, b, sc, sh, al, with_stats=False),),
             lambda: (fuc.block_plain(x, w, b, sc, sh, al),)),
            (("dx", "dck", "dck"), ("dx", "dweight", "dbias"),
             lambda: fuc.upsample2_conv_backward(x, w, gy),
             lambda: fuc.kernel_backward_plain(x, w, gy)),
            ("dck", ("dweight (fold)", "dbias (fold)"),
             lambda: fold_dck(x, w, gy, y, gs),
             lambda: (dweight_plain(x, g), g.sum(dim=(0, 1, 2)))),
            ("dck", ("dweight (transform)",),
             lambda: (dweight(fuc._launch_dck(
                 x, w, gy, in_scale=sc, in_shift=sh, in_alpha=ale)),),
             lambda: (dweight_plain(fuc.block_input(x, sc, sh, al), gy),)),
            (("block_dx",) * 4 + ("block_dck",) * 2,
             ("dx", "dscale", "dshift", "dalpha", "dweight", "dbias"),
             lambda: fuc.fused_block_backward(*args),
             lambda: fuc.block_backward_plain(*args)),
        ]
        if bf16:   # the bf16 block dX kernel alone, on the folded g
            gf = fuc.block_fold(y, gy, v["gs1"], v["gs2"])[0]
            groups.append((
                "block_dx", ("dx (on gf)", "dscale (on gf)",
                             "dshift (on gf)", "dalpha (on gf)"),
                lambda: (lambda r: (r[0], *r[1]))(
                    fuc._launch_dx(x, w, gf, None, None, sc, sh, ale)),
                lambda: fuc.block_grads_plain(x, sc, sh, al, w, gf)[:4]))
        for keys, names, kern, plain in groups:
            got, again = kern(), kern()
            torch.cuda.synchronize()
            want = plain()
            if isinstance(keys, str):
                keys = (keys,) * len(names)
            for key, name, a, a2, p in zip(keys, names, got, again, want):
                err, rel = output_check(
                    f"{shape} {'bf16 ' if bf16 else ''}{key} {name}", a, a2,
                    p, loose=not name.startswith(("y", "dx")))
                worst[key] = max(worst[key], err)
                worst[f"{key}_rel"] = max(worst[f"{key}_rel"], rel)
        del groups, y, args, v, g
        torch.cuda.empty_cache()
    return worst


def kernel_names(fn, calls: int = 3) -> list:
    """The names of the CUDA kernels that ``calls`` calls of ``fn``
    launch. Late in the run a profiler session can drop its kernel records
    (``device_ms``): a session that saw none is asked again, up to three
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.count > 0]
        if names:
            break
    return names


def bf16_forward_kinds(shapes=None, ragged=None) -> dict:
    """Phase 30: which kernel the bf16 forward takes. ``shapes`` (default
    ``g32up_c_shapes``; phase 37: NEW_STAGES) must take the
    warp-specialised TMA kernel (``fuc.fwd_bf16_box``: its box of x
    printed), and the profiler must see it launch; the ``ragged`` shapes
    keep the cp.async kernel and are held against the plain version
    (``output_check``); by default stage 1 with x one element off a
    16-byte boundary, and 6x6 images at stage 2's channels (36 pixels, no
    box). Returns {shape: kernel}."""
    from catgen_torch.kernels import fused_upsample_conv as fuc

    kinds = {}
    ragged = ragged or [("x off 16 bytes", stage_shape(0, TRAIN_B)),
                        ("no box", (TRAIN_B, 6, 6, 512, 256, 3))]
    for tag, shape in ([("stage", sh) for sh in shapes or g32up_c_shapes()]
                       + ragged):
        n, h, w, cin, cout, _ = shape
        v = upsample_inputs(shape, 350, bf16=True)
        x = misaligned(v["x"]) if tag.startswith("x off") else v["x"]
        run = lambda x=x, v=v: fuc.upsample2_conv_fused(  # noqa: E731
            x, v["weight"], v["bias"], v["prelu_c"])
        kind = fuc.forward_kind_bf16(x)
        names = [k for k in kernel_names(run)
                 if "upsample_conv_fwd_bf16" in k]
        seen = ("tma" if names and "upsample_conv_fwd_bf16_tma<" in names[0]
                else "cp_async")
        print(f"bf16 forward at {shape} ({tag}): {kind} kernel (box "
              f"{fuc.fwd_bf16_box(n, h, w, cin, x.data_ptr() % 16 == 0)}), "
              f"the profiler saw {names or 'no kernel in 3 sessions'}")
        require(not names or (len(names) == 1 and seen == kind),
                f"the bf16 forward at {shape} launched {names}, not {kind}")
        require(kind == ("tma" if tag == "stage" else "cp_async"),
                f"the bf16 forward at {shape} ({tag}) took {kind}")
        kinds[f"{shape} ({tag})"] = kind
        if tag != "stage":
            got, again = run(), run()
            want = fuc.block_plain(v["x"], v["weight"], v["bias"],
                                   prelu_alpha=v["prelu_c"])
            output_check(f"{shape} bf16 fwd y ({tag}, {kind} kernel)", got,
                         again, want)
        del v, x
    return kinds


def fold_dck(x, w, gy, y, gs):
    """dCK with the fold (dweight, dbias): in f32 the kernel folds as it
    loads; in bf16 the fold pass runs first and the kernel reads its
    output, as the bf16 block backward does."""
    import torch
    from catgen_torch.kernels import fused_upsample_conv as fuc

    k = w.shape[2]
    if x.dtype == torch.bfloat16:
        gf, db = fuc.block_fold_pass(y, gy, gs[0], gs[1])
        dck = fuc._launch_dck(x, w, gf)
    else:
        dck, db = fuc._launch_dck(x, w, gy, y, gs)
    return fuc.dweight_from_dck(dck, k, k).to(w.dtype), db


F64_TOL = 1e-6             # the 3xTF32 forward against float64


def fwd_vs_float64(shapes=None) -> dict:
    """The forward kernel (3xTF32) as row 3 (bias, per-channel PReLU) and
    as row 4 (the input transform, bias) against float64 (cuDNN in
    double) at ``shapes`` (default G32up-c's three stage shapes at N=640;
    phase 37: NEW_STAGES): y's largest error
    over y's largest value, within F64_TOL, printed beside the plain
    version's own (cuDNN in f32). Returns the kernel's worst per key
    ("fwd", "block")."""
    import torch
    from catgen_torch.kernels import fused_upsample_conv as fuc

    worst = {"fwd": 0.0, "block": 0.0}
    for s, shape in enumerate(shapes or g32up_c_shapes()[:3]):
        v = upsample_inputs(shape, seed=150 + s)
        x, w, b = v["x"], v["weight"], v["bias"]
        runs = {
            "fwd": (lambda: fuc.upsample2_conv_fused(x, w, b, v["prelu_c"]),
                    lambda t: fuc.block_plain(
                        x.to(t), w.to(t), b.to(t),
                        prelu_alpha=v["prelu_c"].to(t))),
            "block": (lambda: fuc.upsample2_conv_block_fused(
                          x, w, b, v["scale"], v["shift"], v["alpha_c"],
                          with_stats=False),
                      lambda t: fuc.block_plain(
                          x.to(t), w.to(t), b.to(t), v["scale"].to(t),
                          v["shift"].to(t), v["alpha_c"].to(t)))}
        for key, (kern, plain) in runs.items():
            got = kern()
            exact = plain(torch.float64)
            top = exact.abs().max().item()
            err = (got.double() - exact).abs().max().item() / top
            err32 = (plain(torch.float32).double() - exact).abs().max(
                ).item() / top
            print(f"{key} y {shape} against float64: kernel {err:.3e}, "
                  f"plain (cuDNN f32) {err32:.3e} of the largest value "
                  f"{top:.4g} (kernel tolerance {F64_TOL})")
            require(err <= F64_TOL, f"{key} is not f32-accurate at {shape}")
            worst[key] = max(worst[key], err)
            del got, exact
        del v, runs
    return worst


def dck_vs_float64(bf16: bool = False, shapes=None,
                   plant: bool = True) -> dict:
    """dweight and dbias of the dCK kernel (3xTF32 in f32, one bf16
    product in bf16) and of the plain version against float64 (cuDNN in
    double) of the same operands: x, or the block's prologue rounded to
    x's dtype, and g, or the fold rounded to it; at ``shapes`` (default
    G32up-c's three stage shapes at N=640; phase 37: NEW_STAGES), row 5
    and row 6. The kernel must be within UP_TIGHT
    of the largest value in f32; in bf16, within BF16_ULPS unit +
    BF16_FLOOR of the largest of the float64 value rounded once to bf16
    (the CPU tests' bound against catgen). The plain version's own error
    is printed beside it: it is what UP_LOOSE (phase 11) and
    BF16_SUM_FLOOR (phase 30) allow for. In bf16 (with ``plant``), each
    of three planted faults at a wrong rounding point must fail phase 30's check against
    the plain version: dCK rounded to bf16 before the chain to dweight,
    dCK kept in bf16 while it is summed over ten slices of the batch, and
    row 5's dbias kept in bf16 while it is summed over the samples.
    Returns the kernel's worst error over the largest value per key
    ("dck", "block_dck")."""
    import torch
    from catgen_torch.kernels import fused_upsample_conv as fuc

    worst = {"dck": 0.0, "block_dck": 0.0}
    for s, shape in enumerate(shapes or g32up_c_shapes()[:3]):
        k = shape[5]
        v = upsample_inputs(shape, (350 if bf16 else 140) + s, bf16)
        x, w, gy, sc, sh, al, gs1, gs2 = (v[a] for a in (
            "x", "weight", "gy", "scale", "shift", "alpha", "gs1", "gs2"))
        y = fuc.block_plain(x, w, v["bias"], sc, sh, al)
        for key in ("dck", "block_dck"):
            if key == "block_dck":
                bwd = (x, sc, sh, al, w, y, gy, gs1, gs2)
                got = fuc.fused_block_backward(*bwd)[4:]
                plain = fuc.block_backward_plain(*bwd)[4:]
                xn = fuc.block_input(x, sc, sh, al)
                g = fuc._fold(y, gy, gs1, gs2).to(x.dtype)
                g64 = (gy.double() + gs1.double()
                       + 2.0 * y.double() * gs2.double())
            else:
                got = fuc.upsample2_conv_backward(x, w, gy)[1:]
                plain = fuc.kernel_backward_plain(x, w, gy)[1:]
                xn, g, g64 = x, gy, gy.double()
            exact = (fuc.dweight_from_dck(fuc._kernel_vjp(
                xn.double(), w.double(), g.double(), need_x=False)[1], k, k),
                g64.sum(dim=(0, 1, 2)))
            del g64
            for name, a, p, e in zip(("dweight", "dbias"), got, plain, exact):
                top = e.abs().max().item()
                if a.dtype == torch.bfloat16:
                    rounded = e.float().bfloat16()
                    ok, err, _, detail = agrees(a, rounded)
                    pok, perr, _, pdetail = agrees(p, rounded)
                    print(f"bf16 {key} {name} {shape} against float64 "
                          f"rounded once: kernel {detail} (required): {ok},"
                          f" {err / top:.3e} of the largest; plain "
                          f"{pdetail}: {pok}, {perr / top:.3e} of the "
                          f"largest")
                else:
                    err = (a.double() - e).abs().max().item()
                    ok = err <= UP_TIGHT * top
                    print(f"{'bf16 ' if bf16 else ''}{key} {name} {shape} "
                          f"against float64: kernel {err / top:.3e}, plain "
                          f"{(p.double() - e).abs().max().item() / top:.3e} "
                          f"of the largest value {top:.4g} (kernel "
                          f"tolerance {UP_TIGHT})")
                require(ok, f"{key} {name} is off float64 at {shape}")
                if name == "dweight":
                    worst[key] = max(worst[key], err / top)
            if bf16:
                # the f32 sums before the one rounding, against float64
                # the block's dCK reads the fold pass's output, as in
                # the block backward
                dck = (fuc._launch_dck(
                    x, w, fuc.block_fold_pass(y, gy, gs1, gs2)[0], None,
                    None, sc, sh, al.expand(shape[3]).contiguous())
                       if key == "block_dck" else fuc._launch_dck(x, w, gy))
                dck_plain = fuc._kernel_vjp(xn, w, g, need_x=False)[1]
                top = exact[0].abs().max().item()
                rel = [(fuc.dweight_from_dck(t, k, k).double()
                        - exact[0]).abs().max().item() / top
                       for t in (dck, dck_plain)]
                print(f"bf16 {key} dweight {shape}, its f32 sums before the "
                      f"rounding against float64: kernel {rel[0]:.3e}, "
                      f"plain {rel[1]:.3e} of the largest value {top:.4g}")
                if plant:
                    faults_fail(key, shape, x, w, xn, g, dck_plain, plain)
                del dck, dck_plain
            del exact, got, plain
        del v, y
        torch.cuda.empty_cache()
    return worst


def faults_fail(key: str, shape, x, w, xn, g, dck, plain) -> None:
    """Bf16 dweight and dbias with a rounding point in the wrong place
    (``dck_vs_float64``), from the operands xn and g and the plain
    version's f32 ``dck``, each of which phase 30's check against the
    ``plain`` (dweight, dbias) must refuse."""
    import torch
    from catgen_torch.kernels import fused_upsample_conv as fuc

    k = shape[5]
    faults = {"dCK rounded to bf16 before the chain to dweight":
              (0, fuc.dweight_from_dck(dck.bfloat16().float(), k, k))}
    part, acc = x.shape[0] // 10, None
    for i in range(10):
        sl = slice(i * part, (i + 1) * part)
        piece = fuc._kernel_vjp(xn[sl], w, g[sl], need_x=False)[1].bfloat16()
        acc = piece if acc is None else acc + piece
    faults["dCK kept in bf16 over ten slices of the batch"] = (
        0, fuc.dweight_from_dck(acc.float(), k, k))
    if plain[1].dtype == torch.bfloat16:
        per_sample = g.float().sum(dim=(1, 2)).bfloat16()
        acc = per_sample[0]
        for row in per_sample[1:]:
            acc = acc + row
        faults["dbias kept in bf16 over the samples"] = (1, acc)
    for what, (i, wrong) in faults.items():
        ok, _, _, detail = agrees(wrong.bfloat16(), plain[i], loose=True)
        print(f"bf16 {key} {shape}, planted fault ({what}) against the plain "
              f"version: {detail}: {ok} (must be False)")
        require(not ok, f"phase 30's check passes a fault: {what}")
    del acc, faults


def dx_vs_float64(shapes=None) -> dict:
    """The dX kernel (3xTF32) and the plain version (cuDNN in f32) against
    float64 autograd (cuDNN in double) at ``shapes`` (default G32up-c's
    three stage shapes at N=640; phase 37: NEW_STAGES), as row 5 (dx of the conv) and as row 6 (the fold and the
    transform's backward): dx's largest error over its largest value,
    within F64_TOL. Row 6's float64 counterpart takes the PReLU branch the
    kernel takes (the sign of x * scale + shift in f32): a float64 sign of
    an xt within an ulp of 0 would pick the other slope. Returns the
    kernel's worst per key ("dx", "block_dx")."""
    import torch
    from catgen_torch.kernels import fused_upsample_conv as fuc

    worst = {"dx": 0.0, "block_dx": 0.0}
    for s, shape in enumerate(shapes or g32up_c_shapes()[:3]):
        v = upsample_inputs(shape, seed=160 + s)
        x, w, gy, sc, sh, al = (v[a] for a in ("x", "weight", "gy", "scale",
                                                 "shift", "alpha"))
        alc = al.expand(shape[3]).contiguous()
        y = fuc.block_plain(x, w, v["bias"], sc, sh, al)
        gs = torch.stack([v["gs1"], v["gs2"]])
        pos = (x * sc + sh) >= 0
        for key in ("dx", "block_dx"):
            block = key == "block_dx"
            if block:
                got = fuc._launch_dx(x, w, gy, y, gs, sc, sh, alc)[0]
            else:
                got = fuc.upsample2_conv_dx(x, w, gy)

            def plain(dtype, block=block):
                t = lambda a: a.to(dtype)                     # noqa: E731
                g = (t(gy) + t(v["gs1"]) + 2.0 * t(y) * t(v["gs2"])
                     if block else t(gy))
                xn = (fuc.in_transform(t(x), t(sc), t(sh), t(al)) if block
                      else t(x))
                dxn = fuc._vjp(lambda x_: fuc.upsample2_conv(x_, t(w)),
                               (xn,), (True,), g)[0]
                if not block:
                    return dxn
                return torch.where(pos, dxn, dxn * t(al)) * t(sc)

            exact = plain(torch.float64)
            top = exact.abs().max().item()
            err = (got.double() - exact).abs().max().item() / top
            err32 = (plain(torch.float32).double() - exact).abs().max(
                ).item() / top
            print(f"{key} dx {shape} against float64: kernel {err:.3e}, "
                  f"plain (cuDNN f32) {err32:.3e} of the largest value "
                  f"{top:.4g} (kernel tolerance {F64_TOL})")
            require(err <= F64_TOL, f"{key} is not f32-accurate at {shape}")
            worst[key] = max(worst[key], err)
            del exact, got
        del v, y, gs, pos
    return worst


def slice_on_route(save: str, name: str, route: dict, default: dict):
    """The sampling CLI on ``route``, 1024 samples from the same checkpoint
    and seed as phase 5: the launches the design gives (ladder: 3 block
    launches per G batch of 256; D's routes: ``expected_sampler``), no
    backward; images and D scores equal to phase 5's default-route run
    within SLICE_ATOL. Returns (D's kernel launches, upsample-conv
    launches)."""
    from catgen_torch.kernels import config as upconfig

    reset_counts()
    with upconfig.using(**route):
        result = run_cli(save, "cuda", COUNT, os.path.join(save, name))
    counts, up = sampler_counts(), upsample_counts()
    want, want_d = (expected_upsample(route, 0, COUNT // 256),
                    expected_sampler(route, 0, COUNT // 256))
    print(f"{name} route: upsample-conv launches {up}, expected {want}; D's "
          f"kernel launches { {k: v for k, v in counts.items() if v} }, "
          f"expected { {k: v for k, v in want_d.items() if v} }")
    require(up == want, f"the {name} route's launches while sampling")
    require(counts == want_d, f"the {name} route's D kernel launches")
    check_finite(result)
    img_err = (result["images"] - default["images"]).abs().max().item()
    score_err = (result["scores"] - default["scores"]).abs().max().item()
    print(f"{name} route against the default route: images max_abs_err "
          f"{img_err:.3e}, D scores {score_err:.3e} (tolerance "
          f"{SLICE_ATOL})")
    require(img_err <= SLICE_ATOL and score_err <= SLICE_ATOL,
            f"the {name} route's samples differ from the default route's")
    return counts, up


def per_layer_steps() -> dict:
    """One train step at batch 64 on the per-layer route, with the dX and
    dCK kernels (upsample_bwd=pallas) and with the dX kernel alone
    (hybrid): launches as designed, losses equal to the default route's
    step from the same weights and draws. Returns the launches of each."""
    import copy

    import torch
    from catgen_torch.core.random import Draws
    from catgen_torch.kernels import config as upconfig
    from catgen_torch.train import gan

    device = torch.device("cuda")
    config = gan.GanConfig(batch_size=64, augment=True)
    g, d = seeded_pair(8, G_GAIN, D_GAIN)
    g, d = g.to(device), d.to(device)
    reals = torch.rand((32, 32, 32, 3), device=device,
                       generator=torch.Generator(device).manual_seed(2))
    out = {}
    for name, route in (("default", None),
                        ("pallas", PER_LAYER),
                        ("hybrid", dict(PER_LAYER, upsample_bwd="hybrid"))):
        gs, ds = copy.deepcopy(g), copy.deepcopy(d)
        state = gan.init_state(gs, ds, config)
        reset_counts()
        with upconfig.using(**(route or {})):
            m = gan.make_train_step(gs, ds, config)(
                state, reals, Draws(torch.Generator(device).manual_seed(3)))
            torch.cuda.synchronize()
        up = upsample_counts()
        want = expected_upsample(route, 1, 0)
        losses = (float(m.loss_d), float(m.loss_g))
        print(f"per-layer step ({name}): losses {losses}; upsample-conv "
              f"launches {up}, expected {want}")
        require(up == want, f"per-layer route ({name}) launches")
        require(all(math.isfinite(v) for v in losses), "non-finite losses")
        out[name] = (up, losses)
    for name in ("pallas", "hybrid"):
        for a, b in zip(out[name][1], out["default"][1]):
            require(abs(a - b) <= 1e-4 * abs(b),
                    f"per-layer ({name}) losses differ from the default "
                    f"route's: {out[name][1]} vs {out['default'][1]}")
    return {k: v[0] for k, v in out.items()}


def kernel_row(tag: str, key: str, kern, plain, library, flops: float,
               nbytes: float, bf16: bool, card_name: str,
               library_device: bool = True) -> dict:
    """One upsample-conv kernel's times at one shape: the kernel (CUDA
    events, and device time from the profiler, the wrapper's weight
    collapse included), its plain version, its cuDNN collapsed-route call
    (``LIBRARY_CALL[key]``: its share of the same work; in device time
    too with ``library_device``) in the same dtype and the bound (3xTF32,
    with the f32 CUDA-core bound beside it, or bf16 on the tensor cores)
    of ``flops`` and ``nbytes``; printed under ``tag``."""
    dtype = "bf16" if bf16 else "f32"
    k1 = cuda_ms(kern, reps=5, inner=3, warmup=2)
    p = cuda_ms(plain, reps=3, inner=2, warmup=1)
    lib = cuda_ms(library, reps=5, inner=3, warmup=2)
    k2 = cuda_ms(kern, reps=5, inner=3, warmup=2)
    dev, _, src = device_ms(kern, calls=20, warmup=1)
    lib_dev, src_lib = None, "not measured"
    if library_device:
        lib_dev, _, src_lib = device_ms(library, calls=20, warmup=1)
    b_ms, b_by = (bound_bf16 if bf16 else bound_3xtf32)(flops, nbytes)
    row = dict(ms=min(k1, k2), plain_ms=p, library_ms=lib, bound_ms=b_ms,
               bound_by=b_by, device_ms=dev, library_device_ms=lib_dev)
    if not bf16:
        row["bound_f32_ms"] = bound(flops, nbytes)[0]
    rate = ("one bf16 product at 989 TFLOP/s" if bf16 else
            f"3xTF32 at 495 TFLOP/s; f32 CUDA cores "
            f"{row['bound_f32_ms']:.4f} ms")
    vs_lib = (f"device {lib_dev:.4f} ms ({src_lib}), device ratio "
              f"{dev / lib_dev:.3f}" if lib_dev else
              f"events ratio {row['ms'] / lib:.3f}")
    print(f"{tag}: kernel {row['ms']:.4f} ms ({k1:.4f} / {k2:.4f}), device "
          f"{dev:.4f} ms ({src}, 20 calls), plain {p:.4f} ms, cuDNN "
          f"{LIBRARY_CALL[key]} in {dtype} (collapsed route) {lib:.4f} ms, "
          f"{vs_lib}; bound {b_ms:.4f} ms ({b_by}; "
          f"{flops / 1e9:.1f} GFLOP, {rate}; {nbytes / 1e6:.1f} MB at 3.35 "
          f"TB/s), {b_ms / dev:.3f} of the bound in device time, "
          f"{flops / dev / 1e9:.1f} TFLOP/s (events: median of 5 timings of "
          f"3 back-to-back calls, order kernel-plain-library-kernel); "
          f"{card_name}")
    return row


def upsample_times(card_name: str, bf16: bool = False, shapes=None,
                   library_device: bool = True) -> dict:
    """At each G32up-c stage shape at B=640 (or each of ``shapes``: phase
    37's NEW_STAGES), in f32 (phase 16) or bf16 (phase 33): each
    upsample-conv kernel (CUDA events, and device time from the profiler,
    the wrapper's weight collapse included), its plain version, the cuDNN
    collapsed route in the same dtype (forward, dgrad or wgrad: its share
    of the same work; in device time too with ``library_device``) and the
    bound (3xTF32, with the f32 CUDA-core bound beside it, or bf16 on the
    tensor cores); then dCK with the fold alone and with the transform
    alone. Returns {key: [per-stage dict]}."""
    import torch
    from catgen_torch.kernels import fused_upsample_conv as fuc
    from catgen_torch.kernels.upsample_conv import upsample2_conv

    out = {key: [] for key, *_ in UP_KERNELS + (BF16_PASSES if bf16 else ())}
    if bf16:
        out["block_backward"] = []
    dtype = "bf16" if bf16 else "f32"
    for s, shape in enumerate(shapes or g32up_c_shapes()[:3]):
        n, h, w, cin, cout, k = shape
        v = upsample_inputs(shape, (330 if bf16 else 90) + s, bf16)
        x, wt, b, gy = v["x"], v["weight"], v["bias"], v["gy"]
        sc, sh, al = v["scale"], v["shift"], v["alpha"]
        alc = al.expand(cin).contiguous()
        gs = torch.stack([v["gs1"], v["gs2"]])
        y = fuc.block_plain(x, wt, b, sc, sh, al)
        xr, wr = x.detach().requires_grad_(), wt.detach().requires_grad_()
        lib_y = upsample2_conv(xr, wr)
        kp = (k + 1) // 2
        flops = 2.0 * n * h * w * 4 * kp * kp * cin * cout
        elem = x.element_size()
        xb, yb = x.numel() * elem, gy.numel() * elem
        wb = 4 * kp * kp * cin * cout * elem
        ckb = 4 * kp * kp * cin * cout * 4          # dCK's f32 sums
        lib_fwd = lambda: upsample2_conv(x, wt)                  # noqa: E731
        lib_dx = lambda: torch.autograd.grad(                    # noqa: E731
            lib_y, [xr], gy, retain_graph=True)
        lib_dw = lambda: torch.autograd.grad(                    # noqa: E731
            lib_y, [wr], gy, retain_graph=True)
        block_bwd = lambda: fuc.block_backward_plain(            # noqa: E731
            x, sc, sh, al, wt, y, gy, v["gs1"], v["gs2"])
        runs = {
            "fwd": (lambda: fuc.upsample2_conv_fused(x, wt, b),
                    lambda: fuc.block_plain(x, wt, b), lib_fwd,
                    xb + wb + yb),
            "block": (lambda: fuc.upsample2_conv_block_fused(
                          x, wt, b, sc, sh, al),
                      lambda: fuc.block_plain(x, wt, b, sc, sh, al,
                                              with_stats=True),
                      lib_fwd, xb + wb + yb),
            "dx": (lambda: fuc.upsample2_conv_dx(x, wt, gy),
                   lambda: fuc.kernel_backward_plain(x, wt, gy),
                   lib_dx, yb + wb + xb),
            "dck": (lambda: fuc._launch_dck(x, wt, gy),
                    lambda: fuc._kernel_vjp(x, wt, gy, need_x=False),
                    lib_dw, xb + yb + ckb),
            "block_dx": (lambda: fuc._launch_dx(x, wt, gy, y, gs, sc, sh,
                                                alc),
                         block_bwd, lib_dx, xb + 2 * yb + wb + xb),
            "block_dck": (lambda: fuc._launch_dck(x, wt, gy, y, gs, sc, sh,
                                                  alc),
                          block_bwd, lib_dw, xb + 2 * yb + ckb),
        }
        if bf16:
            # the bf16 block backward folds once (the fold pass, timed in
            # pass_times) and both kernels read its gf: dX alone (g, the
            # weight and x for the transform's backward read, dx written),
            # dCK with the transform pass (x and gf read, dCK written)
            gf = fuc.block_fold(y, gy, v["gs1"], v["gs2"])[0]
            runs["block_dx"] = (
                lambda: fuc._launch_dx(x, wt, gf, None, None, sc, sh, alc),
                lambda: fuc.block_grads_plain(x, sc, sh, al, wt, gf),
                lib_dx, yb + wb + 2 * xb)
            runs["block_dck"] = (
                lambda: fuc._launch_dck(x, wt, gf, None, None, sc, sh, alc),
                lambda: fuc.block_grads_plain(x, sc, sh, al, wt, gf),
                lib_dw, xb + yb + ckb)
        for key, (kern, plain, library, nbytes) in runs.items():
            out[key].append(kernel_row(
                f"{dtype} {key} stage {s + 1} {shape}", key, kern, plain,
                library, flops, nbytes, bf16, card_name, library_device))
        if bf16:
            pass_times(out, card_name, s, shape, v, y)
            block_backward_time(out, card_name, s, shape, v, y, lib_y,
                                xr, wr, flops, xb, yb, wb, ckb,
                                library_device)
        # what the block backward's fix-ups cost: dCK with the fold alone
        # and with the transform alone, beside the two variants above
        singles = {
            "fold": lambda: fold_dck(x, wt, gy, y, gs),
            "transform": lambda: fuc._launch_dck(x, wt, gy, in_scale=sc,
                                                 in_shift=sh, in_alpha=alc)}
        times = {f: cuda_ms(fn, reps=5, inner=3, warmup=2)
                 for f, fn in singles.items()}
        print(f"{dtype} dck variants stage {s + 1} {shape}: neither "
              f"{out['dck'][-1]['ms']:.4f} ms, fold alone "
              f"{times['fold']:.4f}, transform alone "
              f"{times['transform']:.4f}, both "
              f"{out['block_dck'][-1]['ms']:.4f} (CUDA events); "
              f"{card_name}")
        del runs, lib_y, xr, wr, y, v
        torch.cuda.empty_cache()
    return out


def block_backward_time(out: dict, card_name: str, s: int, shape,
                        v: dict, y, lib_y, xr, wr, flops: float, xb: int,
                        yb: int, wb: int, ckb: int,
                        library_device: bool = True) -> None:
    """Phase 33, beside the bf16 kernels' times at stage ``s``: the bf16
    block backward as one call (``fused_block_backward``: the fold pass,
    dX on its gf, the transform pass and dCK, and the wrapper's work)
    against cuDNN's bf16 dgrad and wgrad in one call (autograd of the
    collapsed route for x and the weight; in device time too with
    ``library_device``), device time from the profiler beside CUDA
    events; its bound counts the products of both kernels and each input
    (x, y, gy, the weight) read once, dx and dCK written once. Appends a
    row to out["block_backward"]."""
    from catgen_torch.kernels import fused_upsample_conv as fuc
    import torch

    args = (v["x"], v["scale"], v["shift"], v["alpha"], v["weight"], y,
            v["gy"], v["gs1"], v["gs2"])
    kern = lambda: fuc.fused_block_backward(*args)            # noqa: E731
    library = lambda: torch.autograd.grad(                     # noqa: E731
        lib_y, [xr, wr], v["gy"], retain_graph=True)
    k1 = cuda_ms(kern, reps=5, inner=3, warmup=2)
    p = cuda_ms(lambda: fuc.block_backward_plain(*args), reps=3, inner=2,
                warmup=1)
    lib = cuda_ms(library, reps=5, inner=3, warmup=2)
    k2 = cuda_ms(kern, reps=5, inner=3, warmup=2)
    dev, names, src = device_ms(kern, calls=20, warmup=1)
    lib_dev, src_lib = None, "not measured"
    if library_device:
        lib_dev, _, src_lib = device_ms(library, calls=20, warmup=1)
    b_ms, b_by = bound_bf16(2 * flops, 2 * xb + 2 * yb + wb + ckb)
    out["block_backward"].append(dict(
        ms=min(k1, k2), plain_ms=p, library_ms=lib, bound_ms=b_ms,
        bound_by=b_by, device_ms=dev, library_device_ms=lib_dev))
    print(f"bf16 block backward stage {s + 1} {shape}: one call "
          f"{min(k1, k2):.4f} ms ({k1:.4f} / {k2:.4f}), device {dev:.4f} ms "
          f"({src}, 20 calls; {len(names)} kernels: fold, dX, transform, "
          f"dCK, sums), plain {p:.4f} ms, cuDNN dgrad + wgrad in bf16 "
          f"(collapsed route, one call) {lib:.4f} ms, "
          + (f"device {lib_dev:.4f} ms ({src_lib}), device ratio "
             f"{dev / lib_dev:.3f}" if lib_dev else
             f"events ratio {min(k1, k2) / lib:.3f}") + "; bound "
          f"{b_ms:.4f} ms ({b_by}), {b_ms / dev:.3f} of the bound in device "
          f"time; {card_name}")


def pass_times(out: dict, card_name: str, s: int, shape, v: dict,
               y) -> None:
    """Phase 33, beside the bf16 kernels' times at stage ``s``: each bf16
    block pass (CUDA events and device time) against its plain version
    and its bound (bytes: each input read once, each output written once;
    its f32 operations at 67 TFLOP/s beside them); no one library call
    computes either. Appends a row per pass to ``out``."""
    from catgen_torch.kernels import fused_upsample_conv as fuc

    x, gy, sc, sh, al = v["x"], v["gy"], v["scale"], v["shift"], v["alpha"]
    cin, cout = x.shape[3], gy.shape[3]
    passes = {
        "transform": (lambda: fuc.block_input_pass(x, sc, sh, al),
                      lambda: fuc.block_input(x, sc, sh, al),
                      2 * x.numel() * 2 + 3 * cin * 2, 3.0 * x.numel()),
        "fold": (lambda: fuc.block_fold_pass(y, gy, v["gs1"], v["gs2"]),
                 lambda: fuc.block_fold(y, gy, v["gs1"], v["gs2"]),
                 3 * gy.numel() * 2 + 3 * cout * 4, 5.0 * gy.numel())}
    for key, (kern, plain, nbytes, ops) in passes.items():
        k1 = cuda_ms(kern, reps=5, inner=3, warmup=2)
        p = cuda_ms(plain, reps=3, inner=2, warmup=1)
        k2 = cuda_ms(kern, reps=5, inner=3, warmup=2)
        dev, _, src = device_ms(kern, warmup=1)   # 100+ calls: tens of us
        b_ms, b_by = bound_bf16(0.0, nbytes, ops)
        out[key].append(dict(ms=min(k1, k2), plain_ms=p, library_ms=None,
                             bound_ms=b_ms, bound_by=b_by, device_ms=dev,
                             library_device_ms=None))
        print(f"bf16 {key} pass stage {s + 1} {shape}: kernel "
              f"{min(k1, k2):.4f} ms ({k1:.4f} / {k2:.4f}), device "
              f"{dev:.4f} ms ({src}), plain {p:.4f} ms, no "
              f"library call; bound {b_ms:.4f} ms ({b_by}; "
              f"{nbytes / 1e6:.1f} MB at 3.35 TB/s, {ops / 1e6:.1f} M f32 "
              f"operations at 67 TFLOP/s), {b_ms / dev:.3f} of the bound in "
              f"device time; {card_name}")


def route_train_times(card_name: str, name: str, route) -> dict:
    """The train step at B=640 with augmentation on ``route``: the step,
    its D and G phases, and one profiled step with each upsample-conv
    kernel's device time per launch."""
    import torch
    from catgen_torch.core.random import Draws
    from catgen_torch.kernels import config as upconfig
    from catgen_torch.train import gan
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda")
    config = gan.GanConfig(batch_size=TRAIN_B, augment=True)
    g, d = seeded_pair(6, G_GAIN, D_GAIN)
    g, d = g.to(device), d.to(device)
    state = gan.init_state(g, d, config)
    step = gan.make_train_step(g, d, config)
    reals = torch.rand((TRAIN_B // 2, 32, 32, 3), device=device)
    draws = Draws(torch.Generator(device).manual_seed(0))
    out = {}
    with upconfig.using(**route):
        out.update(step_modes(lambda: step(state, reals, draws),
                              f"train step on the {name} route, batch "
                              f"{TRAIN_B}", card_name))
        for ph, fn in (("D phase", lambda: step.d_phase(state, reals,
                                                         draws)),
                       ("G phase", lambda: step.g_phase(state, draws,
                                                        device))):
            pm, plo, phi = wall_ms(fn, reps=10)
            out[ph] = pm
            print(f"  {ph}: median {pm:.3f} ms of 10 (min {plo:.3f}, max "
                  f"{phi:.3f})")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, reals, draws)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = [(e, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(us for _, us in kernels)
    if busy == 0:
        print("profiler: no device time seen; breakdown not measured")
        return out
    out["idle_share"] = 1 - busy / 1e6 / wall
    print(f"profiled step ({name}): wall {wall * 1e3:.3f} ms, device "
          f"kernels {busy / 1e3:.3f} ms, idle share {out['idle_share']:.3f}")
    for e, us in sorted(kernels, key=lambda k: -k[1])[:12]:
        print(f"  {us / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    device_ms = {}
    for e, us in kernels:
        if any(k in e.key for k in ("upsample_conv", "sum_rows", "st_conv",
                                    "Layout")):
            print(f"  port kernel in the step: {e.key[:90]} "
                  f"x{e.count}, {us / 1e3:.4f} ms in all, "
                  f"{us / e.count / 1e3:.4f} ms per launch; {card_name}")
            device_ms[e.key] = (us / 1e3, e.count)
    out["device_ms"] = device_ms
    return out


def device_step_ms(times: dict, pattern):
    """Device ms per step of the kernel whose profiler name holds
    ``pattern`` (a string, or a tuple of strings that must all appear; its
    launches at every shape together), or None."""
    patterns = (pattern,) if isinstance(pattern, str) else pattern
    hits = [ms for key, (ms, _) in times.get("device_ms", {}).items()
            if all(p in key for p in patterns)]
    return sum(hits) if hits else None


# ---------------------------------------------------------------------------
# D's fused prefix and the grid-layout sampler (phases 17-20)
# ---------------------------------------------------------------------------

ST_SHAPES = [              # D32_st3's prefix (N, H, W, C, F): train, sample
    (TRAIN_B, 32, 32, 3, 64), (N_SAMPLER, 32, 32, 3, 64)]


def st_inputs(shape, seed: int, channelwise: bool) -> tuple:
    """(img, theta, kernel, bias, alpha) on the card: rotations of up to
    +-17 degrees, scales 0.85-1.15 and shifts that take samples past the
    edges, as D's input transformer makes them."""
    import torch

    n, h, w, c, f = shape
    gen = torch.Generator("cuda").manual_seed(seed)

    def rand(*size):
        return torch.rand(size, generator=gen, device="cuda")

    ang, scale = (rand(n) - 0.5) * 0.6, 0.85 + 0.3 * rand(n)
    cos, sin = torch.cos(ang) * scale, torch.sin(ang) * scale
    ty, tx = (rand(n) - 0.5) * 0.3, (rand(n) - 0.5) * 0.3
    theta = torch.stack([torch.stack([cos, -sin, ty], -1),
                         torch.stack([sin, cos, tx], -1)], 1).contiguous()
    return (rand(n, h, w, c), theta,
            torch.randn((3, 3, c, f), generator=gen, device="cuda") * 0.3,
            torch.randn((f,), generator=gen, device="cuda") * 0.1,
            rand(f if channelwise else 1) * 0.5)


# a bf16 prefix shape off the tensor cores (F % 8 != 0): the CUDA-core
# kernel that the f32 prefix runs (phase 31)
ST_RAGGED = (TRAIN_B, 32, 32, 3, 60)


def st_conv_vs_plain(bf16: bool = False, shapes=ST_SHAPES) -> dict:
    """The ST-conv kernel against its plain version at D32_st3's prefix,
    N=640 and 256 (or ``shapes``: phase 37's 16px prefix), with a shared and a per-channel slope, on an f32 image
    (phase 17) or a bf16 one (phase 31): out and z (``output_check``),
    samp bit for bit (the same lerps at the same coordinates, rounded once
    in bf16); every launch twice, bit-identical; without samp and z (the
    sampling path) the same out. In f32 the prefix's shapes must take the
    tiled kernel (``st_conv.f32_kind`` and the profiler's kernel name),
    and out, z and samp must be the bits of the banded kernel, which a
    misaligned copy of the image takes. In bf16 the prefix's shapes must
    take the tensor-core kernel (``st_conv.bf16_kind``, the profiler's
    kernel name, and its warps a block printed), and ST_RAGGED the
    CUDA-core one. Returns the largest errors."""
    import torch
    from catgen_torch.kernels import st_conv

    worst = dict.fromkeys(("out", "out_rel", "z", "z_rel", "samp"), 0.0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    prefix = shapes
    shapes = shapes + ([ST_RAGGED] if bf16 and shapes == ST_SHAPES else [])
    for i, shape in enumerate(shapes):
        if not bf16:
            kind = st_conv.f32_kind(torch.zeros(shape[:4], device="cuda"),
                                    shape[4])
            print(f"f32 st_conv at {shape}: {kind} kernel")
            require(kind == "tiled", f"the f32 st_conv at {shape} took "
                                     f"{kind}, not tiled")
        if bf16:
            img = torch.zeros(shape[:4], dtype=torch.bfloat16, device="cuda")
            want_kind = "mma" if shape in prefix else "cuda_cores"
            kind = st_conv.bf16_kind(img, shape[4])
            warps = 16 if shape[0] < 4 * sms else 4
            print(f"bf16 st_conv at {shape}: {kind} kernel"
                  + (f", {warps} warps a block ({sms} SMs)"
                     if kind == "mma" else ""))
            require(kind == want_kind, f"the bf16 st_conv at {shape} took "
                                       f"{kind}, not {want_kind}")
        for channelwise in (False, True):
            img, *params = st_inputs(shape, (310 if bf16 else 100) + i,
                                     channelwise)
            args = (img.bfloat16() if bf16 else img, *params)
            if not channelwise:
                names = [k for k in kernel_names(
                    lambda: st_conv.launch(*args)) if "st_conv" in k]
                print(f"  the profiler saw "
                      f"{names or 'no kernel in 3 sessions'}")
                new = "st_conv_bf16_mma<" if bf16 else "st_conv_f32_tiled<"
                require(not names or (
                    len(names) == 1 and (new in names[0])
                    == (shape in prefix)),
                    f"the {'bf16' if bf16 else 'f32'} st_conv at {shape} "
                    f"launched {names}")
            got, again = st_conv.launch(*args), st_conv.launch(*args)
            light = st_conv.launch(*args, save=False)
            torch.cuda.synchronize()
            want = st_conv._forward_plain(*args)
            tag = (f"{'bf16 ' if bf16 else ''}st_conv {shape} "
                   f"{'per-channel' if channelwise else 'shared'} slope")
            for name, a, a2, p in zip(("out", "z"), got[::2], again[::2],
                                      want[::2]):
                err, rel = output_check(f"{tag}, {name}", a, a2,
                                        p.contiguous())
                worst[name] = max(worst[name], err)
                worst[f"{name}_rel"] = max(worst[f"{name}_rel"], rel)
            samp = got[1]
            worst["samp"] = max(worst["samp"], (samp.float() - want[1].float()
                                                ).abs().max().item())
            same = torch.equal(samp, want[1]) and torch.equal(samp, again[1])
            print(f"{tag}, samp: the plain version's bits, repeat "
                  f"bit-identical: {same} (required)")
            require(samp.dtype == args[0].dtype and same,
                    f"{tag}: samp is not the plain version's")
            require(light[1] is None and light[2] is None
                    and torch.equal(light[0], got[0]),
                    f"{tag}: the kernel without samp and z gives another out")
            if not bf16:
                banded = st_conv.launch(misaligned(args[0]), *args[1:])
                banded_light = st_conv.launch(misaligned(args[0]), *args[1:],
                                              save=False)
                torch.cuda.synchronize()
                same = (all(torch.equal(a, b) for a, b in zip(got, banded))
                        and torch.equal(banded_light[0], got[0]))
                print(f"{tag}: out, z and samp the bits of the banded "
                      f"kernel (a misaligned image), with and without samp "
                      f"and z: {same} (required)")
                require(same, f"{tag}: the tiled kernel's bits are not the "
                              f"banded kernel's")
    return worst


def grid_vs_plain() -> dict:
    """The grid-layout sampler kernels against their plain versions at the
    training shapes and at a shape of the per-warp d_coords kernel:
    forward (KERNEL_TOL, and bit for bit where the per-quad or the staged
    kernel runs),
    d_coords and d_img (BWD_ATOL + BWD_RTOL x max |plain|); repeats
    bit-identical. Returns the largest absolute error of each."""
    import torch
    from catgen_torch.kernels import bilinear
    from catgen_torch.kernels import bilinear_grid as bg

    dcoords_kinds()
    forward_kinds(DCOORDS_SHAPES)
    worst = {"fwd": 0.0, "dcoords": 0.0, "dimg": 0.0}
    for i, shape in enumerate(DCOORDS_SHAPES):
        img, rows, (ho, wo) = sampler_inputs(shape, seed=110 + i)
        grid = rows.permute(0, 2, 1).reshape(shape[0], ho, wo, 2).contiguous()
        g = (torch.rand((shape[0], ho, wo, shape[3]), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i))
             * 2 - 1)
        runs = [(bg.launch(img, grid), bg.launch_dcoords(img, grid, g),
                 bg.launch_dimg(img, grid, g)) for _ in range(2)]
        torch.cuda.synchronize()
        want = (bg.bilinear_sample_grid_plain(img, grid),
                *bg.bilinear_sample_grid_backward_plain(img, grid, g)[::-1])
        kind = bilinear.forward_kind(*shape[1:4])
        for name, a, a2, p in zip(("fwd", "dcoords", "dimg"), *runs, want):
            err = (a - p).abs().max().item()
            tol = (KERNEL_TOL if name == "fwd"
                   else BWD_ATOL + BWD_RTOL * p.abs().max().item())
            same = torch.equal(a, a2)
            bits = name == "fwd" and kind in BIT_EXACT_FORWARDS
            print(f"grid {name} {shape}: max_abs_err {err:.3e} (tolerance "
                  f"{tol:.3e}{f'; the {kind} forward: 0, bit for bit' if bits else ''}"
                  f"); repeat bit-identical: {same}")
            require(a.shape == p.shape, f"grid {name} shape")
            require(err <= tol, f"grid {name} disagrees at {shape}")
            require(same, f"grid {name} not deterministic at {shape}")
            require(not bits or torch.equal(a, p),
                    f"the {kind} grid forward's bits at {shape}")
            worst[name] = max(worst[name], err)
    return worst


def generation_steps() -> dict:
    """One train step at batch 64 on the default route and on the v2 and
    v3 grid routes, from the same weights and draws: each route's launches
    as designed, losses equal to the default route's (the kernels compute
    the same f32 arithmetic). Returns the launches of each."""
    import copy

    import torch
    from catgen_torch.core.random import Draws
    from catgen_torch.kernels import config as kconfig
    from catgen_torch.train import gan

    device = torch.device("cuda")
    config = gan.GanConfig(batch_size=64, augment=True)
    g, d = seeded_pair(8, G_GAIN, D_GAIN)
    g, d = g.to(device), d.to(device)
    reals = torch.rand((32, 32, 32, 3), device=device,
                       generator=torch.Generator(device).manual_seed(2))
    out = {}
    for name, route in (("default", None), ("v2", GRID["v2"]),
                        ("v3", GRID["v3"])):
        gs, ds = copy.deepcopy(g), copy.deepcopy(d)
        state = gan.init_state(gs, ds, config)
        reset_counts()
        with kconfig.using(**(route or {})):
            m = gan.make_train_step(gs, ds, config)(
                state, reals, Draws(torch.Generator(device).manual_seed(3)))
            torch.cuda.synchronize()
        counts, want = sampler_counts(), expected_sampler(route, 1, 0)
        losses = (float(m.loss_d), float(m.loss_g))
        print(f"train step ({name}): losses {losses}; D's kernel launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        require(counts == want, f"{name} route's launches, expected {want}")
        require(all(math.isfinite(v) for v in losses), "non-finite losses")
        out[name] = (counts, losses)
    for name in ("v2", "v3"):
        for a, b in zip(out[name][1], out["default"][1]):
            require(abs(a - b) <= 1e-5 * abs(b),
                    f"{name} losses differ from the default route's: "
                    f"{out[name][1]} vs {out['default'][1]}")
    return {k: v[0] for k, v in out.items()}


def st_conv_times(card_name: str, bf16: bool = False, cases=None,
                  banded: bool = True) -> dict:
    """At D32_st3's prefix, on an f32 image (phase 20) or a bf16 one (phase
    33): the ST-conv kernel as the training path runs it (writing samp
    and z) at B=640 and as the sampling path runs it (out alone) at N=256
    (CUDA events, and device time from the profiler), its plain version,
    the split route the default path runs in the same dtype (the v4
    sampler kernel, cuDNN's conv2d and the PReLU; no single PyTorch call
    computes the function), and the bound: the bytes, against the conv's
    products at the rate of their type (f32 on the CUDA cores, bf16 on the
    tensor cores) and the sampler's lerps in f32. In f32 also the
    banded kernel (a misaligned copy of the image takes it) beside the
    tiled one, in the same order of readings (``banded``). ``cases``:
    (shape, samp and z written) pairs in place of the prefix's two
    (phase 37: 16px, without the banded kernel)."""
    import torch
    import torch.nn.functional as F
    from catgen_torch.kernels import bilinear, st_conv

    out = {}
    dtype = "bf16" if bf16 else "f32"
    for shape, save in cases or ((ST_SHAPES[0], True),
                                 (ST_SHAPES[1], False)):
        n, h, w, c, f = shape
        img, theta, kernel, bias, alpha = st_inputs(
            shape, 340 if bf16 else 120, False)
        img = img.bfloat16() if bf16 else img
        kd, bd, ad = (t.to(img.dtype) for t in (kernel, bias, alpha))

        def split(img=img, theta=theta, kd=kd, bd=bd, ad=ad, h=h, w=w):
            rows = bilinear.affine_grid_rows(theta, h, w).to(img.dtype)
            sampled = bilinear.launch(img, rows, (h, w))
            z = F.conv2d(sampled.permute(0, 3, 1, 2), kd.permute(3, 2, 0, 1),
                         bd, padding=1).permute(0, 2, 3, 1)
            return torch.where(z >= 0, z, ad * z)

        args = (img, theta, kernel, bias, alpha)
        kern = (lambda args=args, save=save:
                st_conv.launch(*args, save=save))
        plain = lambda args=args: st_conv._forward_plain(*args)  # noqa: E731
        p1, k1 = cuda_ms(plain, inner=10), cuda_ms(kern, inner=10)
        k2, p2 = cuda_ms(kern, inner=10), cuda_ms(plain, inner=10)
        lib = cuda_ms(split, inner=10)
        dev, names, src = device_ms(kern, calls=100, warmup=3)
        lib_dev, _, src_lib = device_ms(split, calls=100, warmup=3)
        banded_row = {}
        if banded and not bf16:
            args_b = (misaligned(img), theta, kernel, bias, alpha)
            kern_b = (lambda args=args_b, save=save:
                      st_conv.launch(*args, save=save))
            b_dev, b_names, b_src = device_ms(kern_b, calls=100, warmup=3)
            dev2, _, _ = device_ms(kern, calls=100, warmup=3)
            b_dev2, _, _ = device_ms(kern_b, calls=100, warmup=3)
            banded_row = dict(banded_ms=min(cuda_ms(kern_b, inner=10),
                                            cuda_ms(kern_b, inner=10)),
                              banded_device_ms=min(b_dev, b_dev2))
            print(f"f32 st_conv {shape}: the tiled kernel "
                  f"({names[0][:50] if names else '-'}) device {dev:.4f} / "
                  f"{dev2:.4f} ms against the banded kernel "
                  f"({b_names[0][:50] if b_names else '-'}) {b_dev:.4f} / "
                  f"{b_dev2:.4f} ms (order tiled-banded-tiled-banded, "
                  f"{src}/{b_src}); {card_name}")
            dev = min(dev, dev2)
        px, e = n * h * w, img.element_size()
        nbytes = (e * px * c + 4 * n * 6 + e * 9 * c * f + 4 * 2 * f
                  + e * px * f + (e * px * (c + f) if save else 0))
        conv, lerps = 2.0 * 9 * c * f * px, 8.0 * c * px
        b_ms, b_by = (bound_bf16(conv, nbytes, lerps) if bf16
                      else bound(conv + lerps, nbytes))
        row = dict(ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=lib,
                   bound_ms=b_ms, bound_by=b_by, device_ms=dev,
                   library_device_ms=lib_dev, **banded_row)
        out["train" if save else "sample"] = row
        print(f"{dtype} st_conv {shape} "
              f"({'samp and z written' if save else 'out alone'}): kernel "
              f"{row['ms']:.4f} ms ({k1:.4f} / {k2:.4f}), device {dev:.4f} "
              f"ms ({src}), plain {row['plain_ms']:.4f} ms, split route in "
              f"{dtype} (v4 sampler kernel + cuDNN conv2d + PReLU) "
              f"{lib:.4f} ms, device {lib_dev:.4f} ms ({src_lib}); bound "
              f"{b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB at 3.35 TB/s, "
              f"{conv / 1e9:.2f} GFLOP of conv at "
              f"{'989' if bf16 else '67'} TFLOP/s and {lerps / 1e9:.3f} of "
              f"f32 lerps at 67), {b_ms / dev:.3f} of the bound in device "
              f"time (CUDA events, median of 20 timings of 10 back-to-back "
              f"calls, order plain-kernel-kernel-plain-split); {card_name}")
    return out


def grid_times(card_name: str) -> dict:
    """The grid-layout sampler kernels against their plain versions and
    PyTorch's grid_sample and its backward (align_corners, border; NCHW
    input), at the training shapes, as phase 10 times the rows kernels."""
    import torch
    import torch.nn.functional as F
    from catgen_torch.kernels import bilinear_grid as bg

    out = {}
    for key in ("fwd", "dcoords", "dimg"):
        out[key], out[f"{key}_plain"], out[f"{key}_library"] = [], [], []
    for i, shape in enumerate(TRAIN_SHAPES):
        n, h, w, c, ho, wo = shape
        img, rows, _ = sampler_inputs(shape, seed=130 + i)
        grid = rows.permute(0, 2, 1).reshape(n, ho, wo, 2).contiguous()
        gcot = torch.rand((n, ho, wo, c), device="cuda")
        inp = img.permute(0, 3, 1, 2).contiguous()
        gn = gcot.permute(0, 3, 1, 2).contiguous()
        xy = grid.flip(-1).contiguous()           # grid_sample takes (x, y)

        def grid_bwd(mask, gn=gn, inp=inp, xy=xy):
            return torch.ops.aten.grid_sampler_2d_backward(
                gn, inp, xy, 0, 1, True, mask)

        pairs = {
            "fwd": (lambda: bg.launch(img, grid),
                    lambda: bg.bilinear_sample_grid_plain(img, grid),
                    lambda: F.grid_sample(inp, xy, mode="bilinear",
                                          padding_mode="border",
                                          align_corners=True)),
            "dcoords": (lambda: bg.launch_dcoords(img, grid, gcot),
                        lambda: bg.bilinear_sample_grid_backward_plain(
                            img, grid, gcot, need_img=False),
                        lambda: grid_bwd([False, True])),
            "dimg": (lambda: bg.launch_dimg(img, grid, gcot),
                     lambda: bg.bilinear_sample_grid_backward_plain(
                         img, grid, gcot, need_coords=False),
                     lambda: grid_bwd([True, False])),
        }
        for key, (kern, _, library) in pairs.items():
            out.setdefault(f"{key}_device", []).append(sampler_device_line(
                key, "grid", shape, kern, library, card_name))
        for name, (kern, plain, library) in pairs.items():
            p1, k1 = cuda_ms(plain, inner=10), cuda_ms(kern, inner=10)
            k2, p2 = cuda_ms(kern, inner=10), cuda_ms(plain, inner=10)
            lib = cuda_ms(library, inner=10)
            out[name].append(min(k1, k2))
            out[f"{name}_plain"].append(min(p1, p2))
            out[f"{name}_library"].append(lib)
            print(f"grid sampler {name} {shape}: kernel {min(k1, k2):.4f} "
                  f"ms, plain {min(p1, p2):.4f} ms, grid_sample {lib:.4f} ms"
                  f", bound {sampler_bound(name, shape)[0]:.4f} ms (CUDA "
                  f"events, median of 20 timings of 10 back-to-back calls, "
                  f"order plain-kernel-kernel-plain-library); {card_name}")
    return out


# ---------------------------------------------------------------------------
# the V validator and the G pretrainer (phases 21-25)
# ---------------------------------------------------------------------------

V_HALVES = (16, 320)       # half V batches: the reference's 32, bench.py's 640
V_ARGS = ["--fixture", "256", "--epochs", "2", "--batchSize", "32",
          "--N_epoch", "640"]
PRE_ARGS = ["--fixture", "256", "--epochs", "2", "--batchSize", "16",
            "--N_epoch", "320"]
WORKFLOW_ARGS = ["--fixture", "256", "--epochs", "1", "--batchSize", "64",
                 "--N_epoch", "640", "--augment"]
# a gradient that is zero in exact arithmetic (the bias of a layer that
# feeds a BatchNorm) comes out of f32 sums at up to ~3e-6 of the step's
# largest gradient, on either device: both sides within ZERO_FLOOR of it
ZERO_FLOOR = 1e-5


def bn_fed_biases(module, prefix: str = "") -> set:
    """State-dict names of the biases of layers that feed a BatchNorm
    directly, in any nested Sequential."""
    import torch
    from catgen_torch.nn.layers import BatchNorm

    out = set()
    children = list(module.named_children())
    for (name, m), (_, nxt) in zip(children,
                                   children[1:] + [(None, None)]):
        if isinstance(nxt, BatchNorm) and isinstance(
                getattr(m, "bias", None), torch.nn.Parameter):
            out.add(f"{prefix}{name}.bias")
        out |= bn_fed_biases(m, f"{prefix}{name}.")
    return out


def compare_steps(what: str, cpu: tuple, gpu: tuple, before: dict,
                  penalties: tuple, zero: set, lr: float = 1e-3) -> dict:
    """One step's (loss, raw gradients, state_dict after) on the CPU and on
    the card, against phase 9's bounds: the loss within STEP_LOSS_RTOL;
    each gradient leaf within GRAD_REL of its largest plus GRAD_FLOOR of
    the step's largest, but the ``zero`` leaves, which must be rounding
    noise on both sides (ZERO_FLOOR); the weights after the step within
    PARAM_ATOL, except where the penalized gradient (``penalties`` = (l1,
    l2, clamp) at the ``before`` weights) is within that gradient bound of
    zero: Adam's first step moves a weight by about lr*sign(g), so there
    rounding may move it the other way, by up to 2*lr."""
    (lc, gc, pc), (lg, gg, pg) = cpu, gpu
    a, b = float(lg), float(lc)
    print(f"{what} loss: card {a:.7f} cpu {b:.7f} rel err "
          f"{abs(a - b) / max(abs(b), 1e-30):.2e} (tolerance "
          f"{STEP_LOSS_RTOL})")
    require(abs(a - b) <= STEP_LOSS_RTOL * abs(b), f"{what}: loss differs")
    top = max(v.abs().max().item() for v in gc.values())
    bounds, rel = {}, []
    for k, want in gc.items():
        if k in zero:
            worst = max(want.abs().max().item(), gg[k].abs().max().item())
            require(worst <= ZERO_FLOOR * top, f"{what}: {k} is not "
                    f"rounding noise ({worst:.3e})")
            bounds[k] = ZERO_FLOOR * top
            continue
        err = (gg[k] - want).abs().max().item()
        bounds[k] = GRAD_REL * want.abs().max().item() + GRAD_FLOOR * top
        require(err <= bounds[k], f"{what}: gradient {k}: {err:.3e} > "
                                  f"{bounds[k]:.3e}")
        rel.append((err / max(want.abs().max().item(), 1e-30), k))
    rel.sort(reverse=True)
    print(f"{what} gradients: worst per-leaf error over the leaf's largest "
          + ", ".join(f"{k} {r:.2e}" for r, k in rel[:3])
          + f" (tolerance {GRAD_REL}); {len(zero)} bias leaves in front of "
            f"a BatchNorm are rounding noise on both sides")
    l1, l2, clamp = penalties
    worst = 0.0
    moved = n = 0
    for k, want in pc.items():
        err = (pg[k] - want).abs()
        n += err.numel()
        worst = max(worst, err.max().item())
        if k not in gc:                       # BatchNorm statistics
            require(err.max().item() <= PARAM_ATOL, f"{what}: {k} differs")
            continue
        w = before[k]
        g = gc[k] + l1 * w.sign() + l2 * w
        if clamp:
            g = g.clamp(-clamp, clamp)
        clear = err[g.abs() > bounds[k]]
        moved += int((err > PARAM_ATOL).sum())
        require(clear.numel() == 0 or clear.max().item() <= PARAM_ATOL,
                f"{what}: weights of {k} differ where the gradient's sign "
                f"is clear")
    require(worst <= 2 * lr + PARAM_ATOL, f"{what}: a weight moved by more "
            f"than 2*lr")
    print(f"{what} weights after the step: max abs err {worst:.3e}; {moved} "
          f"of {n} beyond {PARAM_ATOL}, each where the penalized gradient's "
          f"sign is rounding (Adam's first step, <= 2*lr)")
    return {"loss_rel": abs(a - b) / max(abs(b), 1e-30),
            "grad_rel": rel[0][0] if rel else 0.0, "param_abs": worst,
            "flipped": moved}


def warp_vs_plain() -> float:
    """Phase 21: the grid forward kernel at the warp generator's shape (C=3,
    32x32 -> 32x32) against its plain version, bit for bit, at half
    batches of 16 and 320, on the grids the generator builds from a bank's
    masks (flows up to 5 px, past every edge)."""
    import torch
    from catgen_torch.core.random import Draws
    from catgen_torch.kernels import bilinear, bilinear_grid
    from catgen_torch.nn import spatial_transformer as st
    from catgen_torch.train import synthetic

    bank = torch.from_numpy(synthetic.build_overlay_bank(
        32, 32, n=64, n_points=2000, seed=3)).cuda()
    seen, real = [], st.bilinear_sample

    def spy(img, coords):
        seen.append((img, coords))
        return real(img, coords)

    worst = 0.0
    st.bilinear_sample = spy
    try:
        for n in V_HALVES:
            draws = Draws(torch.Generator("cuda").manual_seed(n))
            imgs = torch.rand((n, 32, 32, 3), device="cuda",
                              generator=draws.generator)
            seen.clear()
            for _ in range(4):
                synthetic.synthetic_warp(draws, imgs, bank)
            crd = torch.cat([c for _, c in seen])
            past = [bool((crd[..., i] < -1).any()) and
                    bool((crd[..., i] > 1).any()) for i in (0, 1)]
            require(all(past), f"warp grids of half batch {n} stay inside "
                    f"the image: {past}")
            for img, coords in seen:
                got = bilinear_grid.launch(img, coords)
                want = bilinear_grid.bilinear_sample_grid_plain(img, coords)
                worst = max(worst, (got - want).abs().max().item())
                require(torch.equal(got, want), f"the grid forward kernel "
                        f"at the warp shape, half batch {n}, is not the "
                        f"plain version's bits")
            print(f"warp grids, half batch {n}: 4 warps, y in "
                  f"[{crd[..., 0].min().item():.3f}, "
                  f"{crd[..., 0].max().item():.3f}], x in "
                  f"[{crd[..., 1].min().item():.3f}, "
                  f"{crd[..., 1].max().item():.3f}]; kernel "
                  f"{bilinear.forward_kind(32, 32, 3)} equals the plain "
                  f"version bit for bit")
    finally:
        st.bilinear_sample = real
    return worst


def v_cli_on_card(save: str):
    """Phase 22: cli.train_v.main on the card, 2 epochs at the reference's
    batch 32: the epochs, the grids, the V checkpoint, and one grid
    forward launch for every warp batch the host's choices gave (the
    epochs' primary and recursive-mix warps, the visualizations')."""
    from catgen_torch.cli import train_v as train_v_cli
    from catgen_torch.io import checkpoint
    from catgen_torch.kernels import bilinear_grid
    from catgen_torch.train import synthetic, v_trainer

    reset_counts()
    t0 = time.perf_counter()
    harness = train_v_cli.main(V_ARGS + ["--device", "cuda", "--save",
                                         save])
    wall = time.perf_counter() - t0
    print(f"overlay bank: 1000 masks x 10000 walk steps (catgen's), built on "
          f"the host in {harness.bank_seconds:.2f} s; the CLI took "
          f"{wall:.2f} s in all")
    epoch_warps = sum(v_trainer.warp_batches(*c) for c in harness.choices)
    viz_warps = harness.factory.branches.count(synthetic.WARP)
    got = bilinear_grid.launches()
    want = {**dict.fromkeys(bilinear_grid.COUNTERS, 0),
            "LAUNCHES": epoch_warps + viz_warps}
    print(f"grid sampler launches {got}; expected {want['LAUNCHES']}: "
          f"{epoch_warps} warp batches in {harness.state.step} steps (host "
          f"choices) + {viz_warps} in the visualizations")
    require(got == want, "the V path's grid forward launches")
    require(sampler_counts()["fwd"] == 0 and not any(
        upsample_counts().values()), "kernels of other paths launched")
    with open(os.path.join(save, "train_v_metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    epochs = [e for e in events if e["event"] == "epoch"]
    for e in epochs:
        print(f"V epoch {e['epoch']}: loss {e['loss']:.5f} acc "
              f"{e['acc']:.4f} {e['sec']} s (CLI clock)")
    require(len(epochs) == 2 and all(math.isfinite(e["loss"])
                                     for e in epochs), "V epochs")
    for viz in (e for e in events if e["event"] == "viz"):
        require(viz["judged_real"] + viz["judged_fake"] == 100, "V viz")
        grids = [os.path.join(save, d, f"epoch_{viz['epoch']:06d}.png")
                 for d in ("v_judged_real", "v_judged_fake")]
        require(any(os.path.exists(p) for p in grids), "V grids")
    path = os.path.join(save, checkpoint.v_filename(3, 32, 32))
    require(checkpoint.load_meta(path)["epoch"] == 3, "V checkpoint")
    return harness, got


def v_step_card_vs_cpu(bank) -> dict:
    """One V32 step at batch 8 on the CPU and on the card, from the same
    weights, reals, warp-generated fakes and dropout masks."""
    import copy

    import torch
    from catgen_torch import models, optim
    from catgen_torch.core.module import reset_parameters
    from catgen_torch.core.random import Draws
    from catgen_torch.train import synthetic, v_trainer

    v = models.create_V32((32, 32, 3))
    reset_parameters(v, torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    reals = torch.rand((4, 32, 32, 3), generator=gen)
    fakes = synthetic.synthetic_warp(Draws(gen), torch.rand(
        (4, 32, 32, 3), generator=gen), bank.cpu())
    config = v_trainer.VConfig(batch_size=8)
    out, real_cap = {}, optim.clamp_and_penalize
    for dev in ("cpu", "cuda"):
        vd = copy.deepcopy(v).to(dev)
        state = v_trainer.init_state(vd, config)
        grads = []

        def spy(gr, *a, **k):
            grads.append({n: t.detach().cpu() for n, t in gr.items()})
            return real_cap(gr, *a, **k)

        draws = (RecordingDraws(Draws(torch.Generator().manual_seed(9)))
                 if dev == "cpu" else ReplayedDraws(recorded.taken, dev))
        optim.clamp_and_penalize = spy
        try:
            m = v_trainer.make_train_step(vd, config)(
                state, reals.to(dev), fakes.to(dev), draws)
        finally:
            optim.clamp_and_penalize = real_cap
        if dev == "cpu":
            recorded = draws
        out[dev] = (m, grads[0], {k: t.cpu() for k, t in
                                  vd.state_dict().items()})
    for name in ("tp_real", "tn_fake", "fp", "fn"):
        require(int(getattr(out["cuda"][0], name))
                == int(getattr(out["cpu"][0], name)), f"V step {name}")
    return compare_steps(
        "V step (V32, batch 8)",
        (out["cpu"][0].loss, out["cpu"][1], out["cpu"][2]),
        (out["cuda"][0].loss, out["cuda"][1], out["cuda"][2]),
        {k: p.detach() for k, p in v.named_parameters()},
        (config.v_l1, config.v_l2, config.v_clamp), bn_fed_biases(v))


def expected_pretrain(route, steps: int, vizzes: int,
                      stages: int = 3) -> dict:
    """Upsample-conv launches of ``steps`` autoencoder steps and
    ``vizzes`` reconstructions (16 images, eval): a step runs the decoder
    (``stages`` upsample-convs) forward and backward once, a
    reconstruction forward once."""
    from catgen_torch.kernels import fused_upsample_conv

    want = dict.fromkeys(fused_upsample_conv.COUNTERS, 0)
    if route is not None:
        want["BLOCK_LAUNCHES"] = stages * (steps + vizzes)
        want["BLOCK_DX_LAUNCHES"] = want["BLOCK_DCK_LAUNCHES"] = \
            stages * steps
    return want


def pretrain_cli_on_card(save: str, route=None, scale: int = 32) -> dict:
    """Phase 23 (phase 38 at ``scale`` 16: G_enc16 + G16up): cli.
    pretrain_g.main on the card on the default route or on ``route`` (the
    ladder): the epochs, the reconstructions, the decoder checkpoint, the
    upsample-conv launches."""
    from catgen_torch.cli import pretrain_g as pretrain_cli
    from catgen_torch.io import checkpoint
    from catgen_torch.kernels import config as upconfig

    reset_counts()
    with upconfig.using(**(route or {})):
        harness = pretrain_cli.main(PRE_ARGS + ["--device", "cuda",
                                                "--save", save, "--scale",
                                                str(scale)])
    up, steps = upsample_counts(), harness.state.step
    want = expected_pretrain(route, steps, 2, 3 if scale == 32 else 2)
    name = "ladder" if route else "default"
    print(f"{scale}px pretrain CLI ({name} route): {steps} steps; "
          f"upsample-conv launches {up}, expected {want}")
    require(up == want, "the pretrain path's upsample-conv launches")
    with open(os.path.join(save, "pretrain_metrics.jsonl")) as f:
        epochs = [e for e in map(json.loads, f) if e["event"] == "epoch"]
    for e in epochs:
        print(f"pretrain epoch {e['epoch']}: mse {e['mse']:.6f} {e['sec']} s "
              f"(CLI clock)")
    require(len(epochs) == 2 and all(math.isfinite(e["mse"])
                                     for e in epochs), "pretrain epochs")
    require(os.path.getsize(os.path.join(save, "reconstructions",
                                         "epoch_000002.png")) > 0,
            "reconstructions grid")
    path = os.path.join(save, checkpoint.g_pretrained_filename(
        3, scale, scale, 100))
    require(checkpoint.load_meta(path)["epoch"] == 3, "pretrained G file")
    return up


def ladder_pretrain_card_vs_cpu() -> dict:
    """One autoencoder step at batch 4 on the ladder route, CPU (the
    kernels' plain versions) against the card (the kernels: 3 block
    forwards, 3 dX, 3 dCK)."""
    import copy

    import torch
    from catgen_torch import models, optim
    from catgen_torch.core.module import reset_parameters
    from catgen_torch.kernels import config as upconfig
    from catgen_torch.train import pretrainer

    ae = models.create_G_autoencoder((32, 32, 3), 100)
    reset_parameters(ae, torch.Generator().manual_seed(10))
    x = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(11))
    config = pretrainer.PretrainConfig(batch_size=4)
    out, real_cap = {}, optim.clamp_and_penalize
    for dev in ("cpu", "cuda"):
        aed = copy.deepcopy(ae).to(dev)
        state = pretrainer.init_state(aed, config)
        grads = []

        def spy(gr, *a, **k):
            grads.append({n: t.detach().cpu() for n, t in gr.items()})
            return real_cap(gr, *a, **k)

        optim.clamp_and_penalize = spy
        reset_counts()
        try:
            with upconfig.using(**LADDER):
                loss = pretrainer.make_train_step(aed, config)(state,
                                                               x.to(dev))
        finally:
            optim.clamp_and_penalize = real_cap
        if dev == "cuda":
            up = upsample_counts()
            require(up == expected_pretrain(LADDER, 1, 0),
                    f"the ladder step's launches {up}")
        out[dev] = (loss, grads[0], {k: t.cpu() for k, t in
                                     aed.state_dict().items()})
    return compare_steps(
        "pretrain step (ladder route, batch 4)", out["cpu"], out["cuda"],
        {k: p.detach() for k, p in ae.named_parameters()},
        (config.g_l1, config.g_l2, config.g_clamp), bn_fed_biases(ae))


def workflow_on_card(save: str) -> dict:
    """Phase 24: cli.train in the --save of phases 22-23 picks up the V
    checkpoint and the pretrained G, logs V's ratings; then cli.sample
    reads its checkpoint."""
    from catgen_torch.cli import sample as sample_cli
    from catgen_torch.cli import train as train_cli

    reset_counts()
    harness = train_cli.main(WORKFLOW_ARGS + ["--device", "cuda", "--save",
                                              save])
    counts = sampler_counts()
    want = expected_sampler(None, harness.state.step, 2)
    require(counts == want, f"the GAN run's D kernel launches {counts}")
    with open(os.path.join(save, "train_metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    names = [e["event"] for e in events]
    require(names[:3] == ["pretrained_g_loaded", "v_loaded", "setup"],
            f"the GAN run did not pick up both files: {names[:3]}")
    viz = [e for e in events if e["event"] == "viz"][0]
    ratings = {k: viz[k] for k in ("v_rating_all", "v_rating_good",
                                   "v_rating_bad")}
    require(all(0.0 <= r <= 1.0 for r in ratings.values()), "V ratings")
    print(f"GAN run in the same --save: {names[:2]}; {ratings}; "
          f"{harness.state.step} steps, D's launches {counts}")
    runs = sample_cli.main(["--save", save, "--count", "256", "--device",
                            "cuda", "--neighbours"])
    check_finite(runs[0])
    print("sample CLI read its checkpoint on the card: 256 images")
    return ratings


def v_times(card_name: str, bank) -> dict:
    """Phase 25, V: at the reference's batch 32 and bench.py's 640, each
    generator, the two overlay kinds (and the pixelwise scan's host walk),
    and the V update; a V batch averaged over the branch mix (1/4 each,
    then the recursive mix with p=0.33); one profiled V batch of each
    generator."""
    import torch
    from catgen_torch import models
    from catgen_torch.core.module import reset_parameters
    from catgen_torch.core.random import Draws
    from catgen_torch.train import synthetic, v_trainer
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda")
    draws = Draws(torch.Generator(device).manual_seed(12))
    generate = synthetic.make_batch_generator(bank, (32, 32, 3))
    names = ("mix", "warp", "stamp", "random")
    out = {"overlay_gaussian": wall_ms(lambda: synthetic.gaussian_overlays(
        draws, bank, 1, 4), reps=20)[0],
        "overlay_pixelwise": wall_ms(lambda: synthetic.pixelwise_overlays(
            draws, 1, 32, 32), reps=20)[0],
        "pixelwise_walk": wall_ms(lambda: synthetic._threshold_walk(
            torch.rand(1, device=device), torch.rand(1, device=device),
            torch.rand((1024, 1), device=device) < 0.5), reps=20)[0]}
    overlay = (out["overlay_gaussian"] + out["overlay_pixelwise"]) / 2
    print(f"overlays: gaussian {out['overlay_gaussian']:.3f} ms, pixelwise "
          f"{out['overlay_pixelwise']:.3f} ms, of which the host walk "
          f"{out['pixelwise_walk']:.3f} ms; {card_name}")
    for batch in (32, TRAIN_B):
        half = batch // 2
        gen_reals = torch.rand((4, half, 32, 32, 3), device=device)
        reals = torch.rand((half, 32, 32, 3), device=device)
        t = {name: wall_ms(lambda: generate(draws, b, 0, False, gen_reals),
                           reps=20)[0] for b, name in enumerate(names)}
        mix = statistics.mean(t.values())
        t["generation"] = mix + 0.33 * (mix + overlay)
        v = models.create_V32((32, 32, 3))
        reset_parameters(v, torch.Generator().manual_seed(13))
        config = v_trainer.VConfig(batch_size=batch)
        state = v_trainer.init_state(v.to(device), config)
        step = v_trainer.make_train_step(state.v, config)
        fakes = generate(draws, 1, 0, False, gen_reals)
        t["update"] = wall_ms(lambda: step(state, reals, fakes, draws),
                              reps=12)[0]
        t["batch"] = t["generation"] + t["update"]
        print(f"V batch of {batch}: generation {t['generation']:.3f} ms "
              f"(mix {t['mix']:.3f}, warp {t['warp']:.3f}, stamp "
              f"{t['stamp']:.3f}, random {t['random']:.3f}), update "
              f"{t['update']:.3f} ms; {batch / t['batch'] * 1e3:.1f} "
              f"images/s; medians of host-clock timings ending in a "
              f"synchronize; {card_name}")
        idle = {}
        for b, name in enumerate(names):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                f = generate(draws, b, 0, False, gen_reals)
                step(state, reals, f, draws)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kernels)
            idle[name] = 1 - busy / 1e6 / wall if busy else None
            print(f"profiled V batch of {batch} ({name}): wall "
                  f"{wall * 1e3:.3f} ms, device {busy / 1e3:.3f} ms, idle "
                  f"share {idle[name] if idle[name] is None else round(idle[name], 3)}")
            if name == "warp":
                for e in sorted(kernels,
                                key=lambda e: -e.self_device_time_total)[:5]:
                    print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
                          f"x{e.count:<4d} {e.key[:90]}")
        t["idle_share"] = idle
        out[f"batch_{batch}"] = t
    return out


def pretrain_times(card_name: str, route=None) -> dict:
    """Phase 25, pretrain: the autoencoder step at batch 640 on the default
    route or on ``route``, and one profiled step."""
    import torch
    from catgen_torch import models
    from catgen_torch.core.module import reset_parameters
    from catgen_torch.kernels import config as upconfig
    from catgen_torch.train import pretrainer
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda")
    ae = models.create_G_autoencoder((32, 32, 3), 100)
    reset_parameters(ae, torch.Generator().manual_seed(14))
    config = pretrainer.PretrainConfig(batch_size=TRAIN_B)
    state = pretrainer.init_state(ae.to(device), config)
    step = pretrainer.make_train_step(state.ae, config)
    x = torch.rand((TRAIN_B, 32, 32, 3), device=device)
    name = "ladder" if route else "default"
    with upconfig.using(**(route or {})):
        med, lo, hi = wall_ms(lambda: step(state, x), reps=12)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    idle = 1 - busy / 1e6 / wall if busy else None
    print(f"pretrain step ({name} route), batch {TRAIN_B}: median "
          f"{med:.3f} ms of 12 (min {lo:.3f}, max {hi:.3f}) = "
          f"{TRAIN_B / med * 1e3:.1f} images/s; profiled: wall "
          f"{wall * 1e3:.3f} ms, device {busy / 1e3:.3f} ms, idle share "
          f"{idle if idle is None else round(idle, 3)}; {card_name}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")
    return {"step_ms": med, "idle_share": idle}


# ---------------------------------------------------------------------------
# the bf16 train step (phases 26-29): catgen's compute_dtype=bfloat16 on the
# default route, its sampler kernels' bf16 instantiations, and remat
# ---------------------------------------------------------------------------

# the kernels each shape of DCOORDS_SHAPES takes in bf16, (forward,
# d_coords, d_img): a 16-byte vector holds 8 bf16 values, so the 32x32x64
# image (128 KB in bf16) is staged, where f32 takes the per-value forward;
# the bf16 per-quad forward and d_coords are kernels of their own
# (sample_per_quad_bf16, dcoords_per_quad_bf16: 4 output pixels a thread,
# the image widened in shared memory), where f32 keeps the per-pixel
# d_coords
BF16_KINDS = (("per_quad", "per_quad", "per_sample"),
              ("staged", "staged", "gather"),
              ("staged", "staged", "gather"))
# bf16 backward kernels vs the plain version: both are f32 sums, of another
# order, rounded once to bf16, so they may round to neighbouring values:
# within BF16_ULPS units in the last place of the plain value, plus
# BF16_FLOOR of its largest for sums that cancel far below their terms
BF16_ULPS, BF16_FLOOR = 1, 2.0 ** -16
# the bf16 step, card against CPU: every bf16 rounding follows from sums of
# another order (cuDNN's against the CPU's), so the step agrees to bf16
# noise: losses within BF16_LOSS_RTOL; gradients per leaf within
# BF16_GRAD_REL of the leaf's largest plus BF16_GRAD_FLOOR of the update's
# largest (the spatial transformers' localization nets learn through sums
# of bf16 d_coords that cancel); parameters: Adam's first step moves a
# weight by +-lr, so where a gradient's sign is within that noise it moves
# 2*lr the other way: at most BF16_FLIP_SHARE of the weights may differ,
# each by at most PARAM_FLIP_MAX
BF16_LOSS_RTOL, BF16_GRAD_REL, BF16_GRAD_FLOOR = 2e-2, 0.1, 0.05
BF16_FLIP_SHARE = 0.1


def bf16_spacing(t):
    """The spacing of bf16 values at |t| (8 significant bits), in f32."""
    import torch

    mag = t.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_inputs(shape, seed: int):
    """sampler_inputs and a cotangent, rounded to bf16, on the card."""
    import torch

    img, rows, out_hw = sampler_inputs(shape, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    g = torch.rand((shape[0], *out_hw, shape[3]), generator=gen) * 2 - 1
    return img.bfloat16(), rows.bfloat16(), g.cuda().bfloat16(), out_hw


def augment_rows(images, seed: int):
    """The coordinate rows that ``data.ops.augment_batch`` hands the
    sampler for ``images`` (its default route: rows, in the images'
    dtype), from draws seeded by ``seed``."""
    import torch
    from catgen_torch.core.random import Draws
    from catgen_torch.data import ops

    seen = []
    sample = ops.bilinear_sample_rows

    def spy(img, rows, out_hw):
        seen.append(rows)
        return sample(img, rows, out_hw)

    ops.bilinear_sample_rows = spy
    try:
        ops.augment_batch(Draws(torch.Generator("cuda").manual_seed(seed)),
                          images)
    finally:
        ops.bilinear_sample_rows = sample
    require(len(seen) == 1, "the augmentation sampled once")
    return seen[0].contiguous()


def bf16_vs_plain() -> dict:
    """Phase 26: the bf16 sampler kernels against their bf16 plain
    versions at the training shapes (N=640), the 32x32x64 image (N=64),
    the zoomed-in input ST and the augmentation's coordinates (the input
    ST's shape), rows and grid layouts: the kernel each shape
    takes; the forward bit for bit (and the same bits from a misaligned
    image); d_img and d_coords within BF16_ULPS + BF16_FLOOR, repeats bit
    for bit; where d_coords takes the per-quad kernel, the bits of the
    per-pixel kernel it replaced, which a misaligned image takes. Returns
    the largest errors, absolute and in units."""
    import torch
    from catgen_torch.kernels import bilinear
    from catgen_torch.kernels import bilinear_grid as bg

    bf = torch.bfloat16
    for shape, want in zip(DCOORDS_SHAPES, BF16_KINDS):
        got = (bilinear.forward_kind(*shape[1:4], bf),
               bilinear.dcoords_kind(*shape[1:4], bf),
               bilinear.dimg_kind(*shape[1:4], bf))
        print(f"bf16 kernels at {shape}: forward {got[0]}, d_coords "
              f"{got[1]}, d_img {got[2]} (designed: {', '.join(want)})")
        require(got == want, f"the bf16 kernels at {shape}: {got}")
    worst = {"fwd": 0.0, "dcoords": 0.0, "dimg": 0.0, "dcoords_ulps": 0.0,
             "dimg_ulps": 0.0}
    cases = [(s, 1.0, lay) for s in DCOORDS_SHAPES for lay in ("rows",
                                                               "grid")]
    cases.append((TRAIN_SHAPES[0], ZOOM, "rows"))
    # the augmentation samples the reals at the input ST's shape, at its
    # own warps' coordinates (zoom None)
    cases.append((TRAIN_SHAPES[0], None, "rows"))
    for i, (shape, zoom, layout) in enumerate(cases):
        n, h, w, c, ho, wo = shape
        img, rows, g, out_hw = bf16_inputs(shape, seed=200 + i)
        rows = (augment_rows(img, seed=200 + i) if zoom is None
                else (rows * zoom).contiguous())
        if layout == "rows":
            run = {"fwd": lambda im: bilinear.launch(im, rows, out_hw),
                   "dimg": lambda: bilinear.launch_dimg(img, rows, g, out_hw),
                   "dcoords": lambda im=img: bilinear.launch_dcoords(
                       im, rows, g, out_hw)}
        else:
            grid = rows.permute(0, 2, 1).reshape(n, ho, wo, 2).contiguous()
            run = {"fwd": lambda im: bg.launch(im, grid),
                   "dimg": lambda: bg.launch_dimg(img, grid, g),
                   "dcoords": lambda im=img: bg.launch_dcoords(
                       im, grid, g).reshape(n, ho * wo, 2).permute(
                           0, 2, 1).contiguous()}
        fwd, fwd_mis = run["fwd"](img), run["fwd"](misaligned(img))
        got = {k: run[k]() for k in ("dimg", "dcoords")}
        again = {k: run[k]() for k in ("dimg", "dcoords")}
        quad = bilinear.dcoords_kind(h, w, c, bf) == "per_quad"
        dc_mis = run["dcoords"](misaligned(img)) if quad else None
        torch.cuda.synchronize()
        want_fwd = bilinear.bilinear_sample_rows_plain(img, rows, out_hw)
        want = dict(zip(("dimg", "dcoords"),
                        bilinear.bilinear_sample_rows_backward_plain(
                            img, rows, g, out_hw)))
        tag = (f"{shape} {layout}"
               f"{' augmentation' if zoom is None else ''}"
               f"{' zoomed' if zoom not in (None, 1.0) else ''}")
        same = torch.equal(fwd, want_fwd) and torch.equal(fwd, fwd_mis)
        print(f"{tag} bf16 forward: bits equal to the plain version's and to "
              f"the kernel's of a misaligned image: {same} (required)")
        require(fwd.dtype == bf and same, f"the bf16 forward at {tag}")
        if quad:
            same = torch.equal(got["dcoords"], dc_mis)
            print(f"{tag} bf16 d_coords: the per-quad kernel's bits equal "
                  f"to the per-pixel kernel's (a misaligned image): {same} "
                  f"(required)")
            require(same, f"the bf16 per-quad d_coords at {tag} is not the "
                          f"per-pixel kernel's bits")
        for name in ("dimg", "dcoords"):
            a, b = got[name], want[name]
            require(a.dtype == b.dtype == bf and a.shape == b.shape,
                    f"bf16 {name} at {tag}: {a.dtype} {tuple(a.shape)}")
            err = (a.float() - b.float()).abs()
            units = err / bf16_spacing(b)
            bound = (BF16_ULPS * bf16_spacing(b)
                     + BF16_FLOOR * b.float().abs().max())
            ok = bool((err <= bound).all())
            rep = torch.equal(a, again[name])
            print(f"{tag} bf16 {name}: max {units.max().item():.2f} units "
                  f"in the last place, {int((err > 0).sum())} of "
                  f"{err.numel()} values differ; within {BF16_ULPS} unit + "
                  f"{BF16_FLOOR:g} x max: {ok}; repeat bit-identical: {rep}")
            require(ok, f"bf16 {name} disagrees at {tag}")
            require(rep, f"bf16 {name} is not deterministic at {tag}")
            worst[name] = max(worst[name], err.max().item())
            worst[f"{name}_ulps"] = max(worst[f"{name}_ulps"],
                                        units.max().item())
    return worst


def bf16_counts() -> dict:
    """Every launch counter of D's kernels since the last reset: the rows
    kernels' f32 and bf16 counters, the ST-conv kernel's (``st_conv``,
    ``st_conv_bf16``), the grid kernels' (``grid_`` prefix)."""
    from catgen_torch.kernels import bilinear, bilinear_grid, st_conv

    return {**bilinear.launches(), "st_conv": st_conv.LAUNCHES,
            "st_conv_bf16": st_conv.BF16_LAUNCHES,
            **{f"grid_{k}": v for k, v in bilinear_grid.launches().items()}}


def bf16_train_on_card(root: str) -> tuple:
    """Phase 27: the training CLI with --dtype bf16 --augment, one epoch of
    20 steps at batch 64, twice from one seed: each step launches the bf16
    forward 5 times, d_coords 4 and d_img 3 (the visualization samples in
    f32, as catgen's does: 2 D batches, 4 f32 forwards); the sample CLI
    reads the
    checkpoint; the two checkpoints hold the same bits. Then one bf16 step
    on the v1 grid route, for the grid kernels' bf16 launches. Returns
    (the CLI run's counts, its steps, the grid step's counts)."""
    import numpy as np
    import torch
    from catgen_torch.cli import sample as sample_cli
    from catgen_torch.cli import train as train_cli
    from catgen_torch.core.random import Draws
    from catgen_torch.data.fixture import write_fixture_dataset
    from catgen_torch.kernels import config as kconfig
    from catgen_torch.train import gan

    corpus = write_fixture_dataset(os.path.join(root, "corpus"), n=256)
    args = list(TRAIN_ARGS[2:])                # no --fixture: one corpus
    args[args.index("--epochs") + 1] = "1"
    leaves, counts = [], None
    for run in range(2):
        save = os.path.join(root, f"run{run}")
        reset_counts()
        harness = train_cli.main(args + ["--dataset", corpus, "--device",
                                         "cuda", "--save", save, "--seed",
                                         "5", "--dtype", "bf16"])
        if run == 0:
            counts, steps = bf16_counts(), harness.state.step
            expected = dict.fromkeys(counts, 0)
            expected.update(BF16_LAUNCHES=5 * steps,
                            BF16_DCOORDS_LAUNCHES=4 * steps,
                            BF16_DIMG_LAUNCHES=3 * steps, LAUNCHES=4)
            shown = {k: v for k, v in counts.items() if v or expected[k]}
            print(f"bf16 training CLI: {steps} steps, 1 visualization; "
                  f"sampler launches {shown}, expected "
                  f"{ {k: expected[k] for k in shown} } (5 forward, 4 "
                  f"d_coords, 3 d_img bf16 launches a step; the "
                  f"visualization's 2 D batches in f32)")
            require(steps == 20 and counts == expected,
                    "the bf16 training path's kernel launches")
            require(upsample_counts() == expected_upsample(None, 0, 0),
                    "upsample-conv kernels launched on the default route")
            with open(os.path.join(save, "train_metrics.jsonl")) as f:
                epoch = [e for e in map(json.loads, f)
                         if e["event"] == "epoch"][0]
            print(f"bf16 epoch: loss_d {epoch['loss_d']:.5f} loss_g "
                  f"{epoch['loss_g']:.5f} acc_d {epoch['acc_d']:.4f} "
                  f"{epoch['imgs_per_sec']} imgs/s (CLI clock, with "
                  f"warm-up)")
            require(all(math.isfinite(epoch[k]) for k in ("loss_d",
                                                          "loss_g")),
                    "non-finite bf16 losses")
            runs = sample_cli.main(["--save", save, "--count", "256",
                                    "--device", "cuda", "--dataset",
                                    corpus, "--neighbours"])
            check_finite(runs[0])
            print(f"sample CLI read the bf16 run's checkpoint: 256 images, "
                  f"D scores {runs[0]['scores'].min().item():.4f}..."
                  f"{runs[0]['scores'].max().item():.4f}")
        with np.load(os.path.join(save, "adversarial.ckpt")) as z:
            leaves.append({k: z[k] for k in z.files if k != "__meta__"})
    a, b = leaves
    differ = sorted(k for k in a if k not in b
                    or a[k].tobytes() != b[k].tobytes())
    print(f"two same-seed bf16 training CLI runs: {len(a)} checkpoint "
          f"arrays, {len(differ)} differ in any bit"
          f"{': ' + ', '.join(differ[:5]) if differ else ''}")
    require(a.keys() == b.keys() and not differ,
            "same-seed bf16 CLI runs wrote different checkpoints")

    config = gan.GanConfig(batch_size=64, augment=True,
                           compute_dtype=torch.bfloat16)
    g, d = seeded_pair(7, G_GAIN, D_GAIN)
    g, d = g.cuda(), d.cuda()
    reset_counts()
    with kconfig.using(**GRID["v1"]):
        state = gan.init_state(g, d, config)
        step = gan.make_train_step(g, d, config)
        reals = torch.rand((32, 32, 32, 3), device="cuda")
        draws = Draws(torch.Generator("cuda").manual_seed(8))
        step(state, reals, draws)
        grid = bf16_counts()
        require_launches(lambda: step(state, reals, draws),
                         BF16_STEP_DCOORDS["GridLayout"],
                         "one bf16 step on the v1 grid route")
    want = dict.fromkeys(grid, 0)
    want.update(grid_BF16_LAUNCHES=5, grid_BF16_DCOORDS_LAUNCHES=4,
                grid_BF16_DIMG_LAUNCHES=3, grid_V1_LAUNCHES=4)
    print(f"one bf16 step on the v1 grid route: "
          f"{ {k: v for k, v in grid.items() if v} }, expected "
          f"{ {k: v for k, v in want.items() if v} }")
    require(grid == want, "the bf16 grid route's kernel launches")
    return counts, steps, grid


def _state_tensors(state) -> dict:
    """Every tensor of a train state, on the CPU, by name."""
    out = {f"g.{k}": v for k, v in state.g.state_dict().items()}
    out.update({f"d.{k}": v for k, v in state.d.state_dict().items()})
    for name, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        for field, value in zip(type(opt)._fields, opt):
            items = value.items() if isinstance(value, dict) else [("", value)]
            out.update({f"{name}.{field}.{k}": v for k, v in items})
    return {k: v.detach().cpu() for k, v in out.items()}


def bf16_step_card_vs_cpu() -> dict:
    """Phase 28: one bf16 step at batch 8 with augmentation, and the same
    step with remat, on the CPU and on the card from the same weights and
    draws (recorded on the CPU, replayed on the card). On each device the
    remat step is the plain step bit for bit (metrics, gradients,
    parameters, BatchNorm statistics, optimizer states) and draws the same
    (the CPU's recordings are equal, and so is the next draw of the card's
    own generator); card against CPU within the BF16_* bounds."""
    import copy
    import dataclasses

    import torch
    from catgen_torch import optim
    from catgen_torch.core.random import Draws
    from catgen_torch.train import gan

    config = gan.GanConfig(batch_size=8, augment=True,
                           compute_dtype=torch.bfloat16)
    g, d = seeded_pair(3, G_GAIN, D_GAIN)
    reals = torch.rand((4, 32, 32, 3),
                       generator=torch.Generator().manual_seed(4))
    real_cap = optim.clamp_and_penalize
    runs, recorded = {}, {}

    def one(dev, remat, draws):
        gd, dd = copy.deepcopy(g).to(dev), copy.deepcopy(d).to(dev)
        cfg = dataclasses.replace(config, remat=remat)
        state = gan.init_state(gd, dd, cfg)
        grads = []

        def spy(gr, *a, **k):
            grads.append({n: t.detach().cpu() for n, t in gr.items()})
            return real_cap(gr, *a, **k)

        optim.clamp_and_penalize = spy
        try:
            m = gan.make_train_step(gd, dd, cfg)(state, reals.to(dev), draws)
        finally:
            optim.clamp_and_penalize = real_cap
        return m, grads, _state_tensors(state)

    mode = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            rec = RecordingDraws(Draws(torch.Generator().manual_seed(5)))
            runs[("cpu", remat)] = one("cpu", remat, rec)
            recorded[remat] = rec.taken + [rec.draws.uniform((4,))]
        for remat in (False, True):
            replay = ReplayedDraws(recorded[False][:-1], "cuda")
            reset_counts()
            runs[("cuda", remat)] = one("cuda", remat, replay)
            require(not replay.taken, "the card drew less than the CPU")
            counts = {k: v for k, v in bf16_counts().items() if v}
            print(f"bf16 step on the card{' with remat' if remat else ''}: "
                  f"sampler launches {counts}")
            if not remat:
                require(counts == {"BF16_LAUNCHES": 5,
                                   "BF16_DCOORDS_LAUNCHES": 4,
                                   "BF16_DIMG_LAUNCHES": 3},
                        "the bf16 step's kernel launches")
        own = {}
        for remat in (False, True):
            draws = Draws(torch.Generator("cuda").manual_seed(6))
            own[remat] = (one("cuda", remat, draws), draws.uniform((4,)))
    finally:
        torch.backends.cudnn.deterministic = mode

    def same(a, b):
        (ma, ga, sa), (mb, gb, sb) = a, b
        return (all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(ma, mb))
                and len(ga) == len(gb)
                and all(torch.equal(x[k], y[k]) for x, y in zip(ga, gb)
                        for k in x)
                and sa.keys() == sb.keys()
                and all(torch.equal(sa[k], sb[k]) for k in sa))

    draws_same = len(recorded[False]) == len(recorded[True]) and all(
        torch.equal(x, y) for x, y in zip(recorded[False], recorded[True]))
    checks = {"cpu": same(runs[("cpu", False)], runs[("cpu", True)]),
              "cuda": same(runs[("cuda", False)], runs[("cuda", True)]),
              "cuda_own_draws": same(own[False][0], own[True][0])
              and torch.equal(own[False][1], own[True][1])}
    print(f"remat step equals the plain step bit for bit (metrics, "
          f"gradients, parameters, BN statistics, optimizer states): "
          f"{checks}; the CPU's draws and its next draw equal: {draws_same}")
    require(all(checks.values()) and draws_same,
            "the remat step differs from the plain step")

    return compare_bf16_steps(runs[("cpu", False)], runs[("cuda", False)],
                              "bf16 step")


def compare_bf16_steps(cpu, card, what: str) -> dict:
    """A bf16 step's (metrics, gradients, state tensors) on the card
    against the CPU's, within the BF16_* bounds; returns the worst
    gradient error over the update's largest and the parameters'
    errors."""
    import torch

    (mc, gc, pc), (mg, gg, pg) = cpu, card
    for name in ("loss_d", "loss_g", "acc_d"):
        a, b = float(getattr(mg, name)), float(getattr(mc, name))
        print(f"{what}, {name}: card {a:.6f} cpu {b:.6f} rel err "
              f"{abs(a - b) / max(abs(b), 1e-30):.2e} (tolerance "
              f"{BF16_LOSS_RTOL})")
        require(abs(a - b) <= BF16_LOSS_RTOL * abs(b), f"{what}: {name}")
    worst_grad = 0.0
    for phase_name, a, b in zip("DG", gg, gc):
        top = max(v.abs().max().item() for v in b.values())
        for k in b:
            err = (a[k] - b[k]).abs().max().item()
            bound = (BF16_GRAD_REL * b[k].abs().max().item()
                     + BF16_GRAD_FLOOR * top)
            require(err <= bound, f"{what}: {phase_name} gradient {k}: "
                                  f"{err:.3e} > {bound:.3e}")
            worst_grad = max(worst_grad, err / top)
    n = beyond = 0
    worst = 0.0
    for k, want in pc.items():
        if not want.is_floating_point():
            require(torch.equal(pg[k], want), f"{what}: {k}")
            continue
        err = (pg[k].float() - want.float()).abs()
        n += err.numel()
        beyond += int((err > PARAM_ATOL).sum())
        worst = max(worst, err.max().item())
    print(f"{what}, card vs CPU: gradients within {BF16_GRAD_REL} of the "
          f"leaf + {BF16_GRAD_FLOOR} of the largest (worst {worst_grad:.3f}"
          f" of the largest); parameters and states max abs err "
          f"{worst:.3e}, {beyond} of {n} beyond {PARAM_ATOL} (Adam sign "
          f"flips; allowed {BF16_FLIP_SHARE:g} of them, each <= "
          f"{PARAM_FLIP_MAX})")
    require(worst <= PARAM_FLIP_MAX, "bf16 parameters differ beyond 2*lr")
    require(beyond <= BF16_FLIP_SHARE * n, "too many bf16 parameters differ")
    return {"grad_worst_of_largest": worst_grad, "param_abs": worst,
            "param_share_beyond": beyond / n}


# the bf16 C=3 d_coords kernels of a bf16 step, by the strings of their
# profiler names: the per-quad kernel twice (the input ST in the D and the
# G phase), the per-pixel kernel it replaced never
BF16_STEP_DCOORDS = {
    layout: {"dcoords_per_quad_bf16": (("dcoords_per_quad_bf16<", layout), 2),
             "dcoords_per_pixel bf16": (("dcoords_per_pixel<",
                                         "__nv_bfloat16"), 0)}
    for layout in ("RowsLayout", "GridLayout")}


def require_launches(fn, want: dict, what: str) -> dict:
    """Runs ``fn`` (one step) under the profiler and requires each named
    kernel's launches: ``want`` maps a label to (the strings its profiler
    name holds, the launches designed). A session can drop kernel records
    (``device_ms``), so one that counts otherwise is asked again, up to
    three times. Returns the last session's counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    designed = {label: n for label, (_, n) in want.items()}
    got = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        got = {label: sum(e.count for e in kernels
                          if all(p in e.key for p in names))
               for label, (names, _) in want.items()}
        if got == designed:
            break
    print(f"{what}: launches by kernel in a profiled step {got}, designed "
          f"{designed}")
    require(got == designed, f"{what}: the kernels launched {got}")
    return got


def bf16_step_times(card_name: str, dtype, remat: bool,
                    route=None, route_name: str = "",
                    want_kernels=None, pair=None, batch: int = TRAIN_B,
                    image=(32, 32, 3)) -> dict:
    """One configuration of phases 29 and 33: bench.py's train step (batch
    640, augmentation, logit BCE, Adam) in ``dtype``, with or without
    remat, on the default route or on ``route``: median step of 10,
    images/s, peak device memory, profiled idle share, and each port
    kernel's device time in the profiled step (``device_ms``: name ->
    (ms, launches)); with ``want_kernels`` one more step, whose kernels
    must launch as ``require_launches`` says. ``pair`` makes (G, D)
    (default: the flagship pair, seeded) for ``image`` at ``batch``."""
    import contextlib

    import torch
    from catgen_torch.core.random import Draws
    from catgen_torch.kernels import config as upconfig
    from catgen_torch.train import gan
    from torch.profiler import ProfilerActivity, profile

    config = gan.GanConfig(batch_size=batch, augment=True,
                           compute_dtype=dtype, remat=remat)
    g, d = pair() if pair else seeded_pair(6, G_GAIN, D_GAIN)
    g, d = g.cuda(), d.cuda()
    state = gan.init_state(g, d, config)
    step = gan.make_train_step(g, d, config)
    reals = torch.rand((batch // 2, *image), device="cuda")
    draws = Draws(torch.Generator("cuda").manual_seed(0))
    with (upconfig.using(**route) if route else contextlib.nullcontext()):
        for _ in range(2):
            step(state, reals, draws)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, reals, draws)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        med, lo, hi = wall_ms(lambda: step(state, reals, draws), reps=10,
                              warmup=0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, reals, draws)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        name = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}" + \
            (" remat" if remat else "") + (f" {route_name} route"
                                           if route_name else "")
        if want_kernels:
            require_launches(lambda: step(state, reals, draws), want_kernels,
                             f"train step {name}")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    idle = 1 - busy / 1e6 / wall if busy else None
    device = {e.key: (e.self_device_time_total / 1e3, e.count)
              for e in kernels if any(k in e.key for k in (
                  "upsample_conv", "sum_rows", "st_conv", "Layout"))}
    print(f"train step {name}, batch {batch}: median {med:.3f} ms of 10 "
          f"(min {lo:.3f}, max {hi:.3f}) = {2 * batch / med * 1e3:.1f} "
          f"images/s; peak device memory {peak / 2 ** 30:.3f} GiB; "
          f"profiled step: wall {wall * 1e3:.3f} ms, device kernels "
          f"{busy / 1e3:.3f} ms, idle share "
          f"{'not measured' if idle is None else round(idle, 3)}; "
          f"{card_name}")
    for key, (ms, count) in sorted(device.items(), key=lambda i: -i[1][0]):
        print(f"  port kernel in the step: {key[:90]} x{count}, {ms:.4f} ms "
              f"in all; {card_name}")
    return {"step_ms": med, "step_min_ms": lo, "step_max_ms": hi,
            "images_per_s": 2 * batch / med * 1e3,
            "peak_bytes": peak, "idle_share": idle,
            "device_ms": busy / 1e3, "kernel_device_ms": device}


def bf16_times(card_name: str, v_generation_ms: float) -> dict:
    """Phase 29, at batch 640 in one run: the f32 and the bf16 train step,
    both again with remat (time and peak memory); the V update in f32 and
    bf16 (the generation runs in f32 either way; phase 25's time stands in
    for it); each bf16 sampler kernel, rows and grid layouts, against its
    plain version, its bf16 library call and its bound."""
    import torch
    import torch.nn.functional as F
    from catgen_torch import models
    from catgen_torch.core.module import reset_parameters
    from catgen_torch.core.random import Draws
    from catgen_torch.kernels import bilinear
    from catgen_torch.kernels import bilinear_grid as bg
    from catgen_torch.train import v_trainer

    out = {}
    for dtype, remat in ((torch.float32, False), (torch.bfloat16, False),
                         (torch.bfloat16, True), (torch.float32, True)):
        key = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}" + \
            ("_remat" if remat else "")
        out[key] = bf16_step_times(
            card_name, dtype, remat, want_kernels=BF16_STEP_DCOORDS[
                "RowsLayout"] if key == "bf16" else None)
        torch.cuda.empty_cache()
    print(f"bf16 step {out['bf16']['step_ms']:.3f} ms against f32 "
          f"{out['f32']['step_ms']:.3f} ms (ratio "
          f"{out['bf16']['step_ms'] / out['f32']['step_ms']:.3f}); remat "
          f"peak memory {out['bf16_remat']['peak_bytes'] / 2 ** 30:.3f} GiB "
          f"(bf16) and {out['f32_remat']['peak_bytes'] / 2 ** 30:.3f} GiB "
          f"(f32) against {out['bf16']['peak_bytes'] / 2 ** 30:.3f} and "
          f"{out['f32']['peak_bytes'] / 2 ** 30:.3f} without (same run); "
          f"{card_name}")

    device = torch.device("cuda")
    half = TRAIN_B // 2
    reals = torch.rand((half, 32, 32, 3), device=device)
    fakes = torch.rand((half, 32, 32, 3), device=device)
    draws = Draws(torch.Generator(device).manual_seed(14))
    for dtype in (torch.float32, torch.bfloat16):
        v = models.create_V32((32, 32, 3))
        reset_parameters(v, torch.Generator().manual_seed(13))
        config = v_trainer.VConfig(batch_size=TRAIN_B, compute_dtype=dtype)
        state = v_trainer.init_state(v.to(device), config)
        step = v_trainer.make_train_step(state.v, config)
        update = wall_ms(lambda: step(state, reals, fakes, draws),
                         reps=12)[0]
        key = "v_bf16" if dtype == torch.bfloat16 else "v_f32"
        out[key] = {"update_ms": update,
                    "batch_ms": v_generation_ms + update}
        print(f"V batch of {TRAIN_B} ({key[2:]}): update {update:.3f} ms, "
              f"with phase 25's mean generation {v_generation_ms:.3f} ms "
              f"(f32 in both: the warp runs before the cast) "
              f"{TRAIN_B / (v_generation_ms + update) * 1e3:.1f} images/s; "
              f"{card_name}")

    for layout in ("rows", "grid"):
        for key in ("fwd", "dcoords", "dimg"):
            for part in ("", "_plain", "_library", "_device"):
                out[f"{layout}_{key}{part}"] = []
        for i, shape in enumerate(TRAIN_SHAPES):
            n, h, w, c, ho, wo = shape
            img, rows, gcot, out_hw = bf16_inputs(shape, seed=260 + i)
            grid = rows.permute(0, 2, 1).reshape(n, ho, wo, 2).contiguous()
            inp = img.permute(0, 3, 1, 2).contiguous()
            gn = gcot.permute(0, 3, 1, 2).contiguous()
            xy = grid.flip(-1).contiguous()       # grid_sample takes (x, y)

            def grid_bwd(mask, gn=gn, inp=inp, xy=xy):
                return torch.ops.aten.grid_sampler_2d_backward(
                    gn, inp, xy, 0, 1, True, mask)

            library = {
                "fwd": lambda: F.grid_sample(inp, xy, mode="bilinear",
                                             padding_mode="border",
                                             align_corners=True),
                "dcoords": lambda: grid_bwd([False, True]),
                "dimg": lambda: grid_bwd([True, False])}
            if layout == "rows":
                pairs = {
                    "fwd": (lambda: bilinear.launch(img, rows, out_hw),
                            lambda: bilinear.bilinear_sample_rows_plain(
                                img, rows, out_hw)),
                    "dcoords": (lambda: bilinear.launch_dcoords(
                        img, rows, gcot, out_hw),
                        lambda: bilinear.bilinear_sample_rows_backward_plain(
                            img, rows, gcot, out_hw, need_img=False)),
                    "dimg": (lambda: bilinear.launch_dimg(img, rows, gcot,
                                                          out_hw),
                             lambda: bilinear.bilinear_sample_rows_backward_plain(
                                 img, rows, gcot, out_hw, need_coords=False))}
            else:
                pairs = {
                    "fwd": (lambda: bg.launch(img, grid),
                            lambda: bg.bilinear_sample_grid_plain(img, grid)),
                    "dcoords": (lambda: bg.launch_dcoords(img, grid, gcot),
                                lambda: bg.bilinear_sample_grid_backward_plain(
                                    img, grid, gcot, need_img=False)),
                    "dimg": (lambda: bg.launch_dimg(img, grid, gcot),
                             lambda: bg.bilinear_sample_grid_backward_plain(
                                 img, grid, gcot, need_coords=False))}
            for key, (kern, plain) in pairs.items():
                p1, k1 = cuda_ms(plain, inner=10), cuda_ms(kern, inner=10)
                k2, p2 = cuda_ms(kern, inner=10), cuda_ms(plain, inner=10)
                lib = cuda_ms(library[key], inner=10)
                bound = sampler_bound(key, shape, 2)[0]
                out[f"{layout}_{key}"].append(min(k1, k2))
                out[f"{layout}_{key}_plain"].append(min(p1, p2))
                out[f"{layout}_{key}_library"].append(lib)
                print(f"bf16 sampler {key} {layout} {shape}: kernel "
                      f"{min(k1, k2):.4f} ms, plain {min(p1, p2):.4f} ms, "
                      f"{SAMPLER_LIBRARY[key]} in bf16 {lib:.4f} ms, bound "
                      f"{bound:.4f} ms (bf16 bytes at 3.35 TB/s; CUDA events, "
                      f"median of 20 timings of 10 back-to-back calls, order "
                      f"plain-kernel-kernel-plain-library); {card_name}")
                if layout == "rows":
                    out[f"rows_{key}_device"].append(sampler_device_line(
                        key, "rows bf16", shape, kern, library[key],
                        card_name, elem=2))
    return out


# ---------------------------------------------------------------------------
# the kernel routes in bf16 (phases 30-33): the upsample-conv kernels' and
# the ST-conv kernel's bf16 instantiations on G's ladder and per-layer
# routes and on D's fused prefix
# ---------------------------------------------------------------------------

BF16_FLOPS = 989e12        # H100 SXM: bf16 on the tensor cores, dense
# a bf16 output that sums over every pixel of the batch (dW, dbias) against
# its plain version: one unit in the last place plus the f32 allowance
# phase 11 gives such sums (UP_LOOSE of the largest): the plain version's
# f32 wgrad (cuDNN) is up to ~5.5e-5 of the largest off float64 before its
# rounding, the kernel's within 1e-6 (dck_vs_float64, which holds the
# kernel to BF16_FLOOR against float64 and checks that rounding faults
# fail this floor)
BF16_SUM_FLOOR = UP_LOOSE
BF16_UP_KERNELS = tuple((key, f"{name}_bf16", f"BF16_{counter}", replaces,
                         source)
                        for key, name, counter, replaces, source in UP_KERNELS)
# the bf16 block's elementwise passes: key, name, counter, TPU kernel (and
# the other it takes a piece of)
BF16_PASSES = (
    ("transform", "block_input_pass_bf16", "BF16_TRANSFORM_LAUNCHES",
     "catgen/kernels/pallas_upsample_conv.py:332",
     ["catgen/kernels/pallas_upsample_conv_bwd.py:343"]),
    ("fold", "block_fold_pass_bf16", "BF16_FOLD_LAUNCHES",
     "catgen/kernels/pallas_upsample_conv_bwd.py:343", []))
BF16_ROUTES = (("ladder", LADDER), ("per-layer", PER_LAYER),
               ("per-layer hybrid", dict(PER_LAYER, upsample_bwd="hybrid")),
               ("fused-prefix", FUSED))


def bound_bf16(flops: float, nbytes: float, f32_ops: float = 0.0) -> tuple:
    """(least ms, what bounds it): the larger of the bf16 products' flops
    over the card's bf16 tensor-core rate (plus any f32 operations beside
    them over its f32 rate) and the bytes over its memory rate."""
    t_ops = flops / BF16_FLOPS + f32_ops / F32_FLOPS
    t_bytes = nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bf16_route_counts() -> dict:
    """Every launch counter since the last reset: D's kernels'
    (``bf16_counts``) and the upsample-conv kernels' (prefix ``up_``)."""
    return {**bf16_counts(),
            **{f"up_{k}": v for k, v in upsample_counts().items()}}


def expected_bf16_route(route, steps: int, g_evals: int,
                        d_evals: int, stages: int = 3) -> dict:
    """``bf16_route_counts`` as the design gives them for ``steps`` bf16
    train steps with augmentation on ``route``, with ``g_evals`` G and
    ``d_evals`` D batches in f32 (the visualization samples in f32): the
    steps' launches on the bf16 instantiations, as ``expected_upsample``
    and ``expected_sampler`` count them in f32."""
    from catgen_torch.kernels import fused_upsample_conv as fuc

    up32, up16 = (expected_upsample(route, 0, g_evals, stages),
                  expected_upsample(route, steps, 0, stages))
    d32, d16 = (expected_sampler(route, 0, d_evals),
                expected_sampler(route, steps, 0))
    want = dict.fromkeys(bf16_route_counts(), 0)
    for k in fuc.F32_COUNTERS:
        want[f"up_{k}"], want[f"up_BF16_{k}"] = up32[k], up16[k]
    # every bf16 block forward transforms its input in a pass of its own,
    # every bf16 block dCK transforms and folds (the transform again: xn
    # is not kept)
    want["up_BF16_TRANSFORM_LAUNCHES"] = (up16["BLOCK_LAUNCHES"]
                                          + up16["BLOCK_DCK_LAUNCHES"])
    want["up_BF16_FOLD_LAUNCHES"] = up16["BLOCK_DCK_LAUNCHES"]
    want.update(LAUNCHES=d32["fwd"], DCOORDS_LAUNCHES=d32["dcoords"],
                DIMG_LAUNCHES=d32["dimg"], BF16_LAUNCHES=d16["fwd"],
                BF16_DCOORDS_LAUNCHES=d16["dcoords"],
                BF16_DIMG_LAUNCHES=d16["dimg"], st_conv=d32["st_conv"],
                st_conv_bf16=d16["st_conv"])
    return want


def bf16_routes_cli(root: str) -> dict:
    """Phase 32, first part: the training CLI with --dtype bf16 --augment
    (one epoch of 20 steps at batch 64) on the ladder and on the
    fused-prefix routes, twice each from one seed: every launch as the
    design gives it (per step on the bf16 instantiations: ladder 6 block
    forwards, 3 block dX, 3 block dCK, and the passes, 9 transforms and 3
    folds; fused prefix 2 ST-conv, 3 sampler
    forwards, 4 d_coords, 3 d_img; the visualization's G and D batches
    in f32), and the same checkpoint bits from both runs. Returns each
    route's counts and steps."""
    import numpy as np
    from catgen_torch.cli import train as train_cli
    from catgen_torch.data.fixture import write_fixture_dataset
    from catgen_torch.kernels import config as upconfig

    corpus = write_fixture_dataset(os.path.join(root, "corpus"), n=256)
    args = list(TRAIN_ARGS[2:])                # no --fixture: one corpus
    args[args.index("--epochs") + 1] = "1"
    out = {}
    for name, route in (("ladder", LADDER), ("fused-prefix", FUSED)):
        leaves = []
        for run in range(2):
            save = os.path.join(root, f"{name}{run}")
            reset_counts()
            with upconfig.using(**route):
                harness = train_cli.main(
                    args + ["--dataset", corpus, "--device", "cuda",
                            "--save", save, "--seed", "5", "--dtype",
                            "bf16"])
            if run == 0:
                counts, steps = bf16_route_counts(), harness.state.step
                want = expected_bf16_route(route, steps, 1, 2)
                shown = {k: v for k, v in counts.items() if v or want[k]}
                print(f"bf16 training CLI on the {name} route: {steps} "
                      f"steps, 1 visualization; launches {shown}, expected "
                      f"{ {k: want[k] for k in shown} }")
                require(steps == 20 and counts == want,
                        f"the bf16 {name} route's kernel launches")
                with open(os.path.join(save, "train_metrics.jsonl")) as f:
                    epoch = [e for e in map(json.loads, f)
                             if e["event"] == "epoch"][0]
                print(f"bf16 {name} epoch: loss_d {epoch['loss_d']:.5f} "
                      f"loss_g {epoch['loss_g']:.5f} acc_d "
                      f"{epoch['acc_d']:.4f}")
                require(all(math.isfinite(epoch[k])
                            for k in ("loss_d", "loss_g")),
                        f"non-finite bf16 losses on the {name} route")
                out[name] = (counts, steps)
            with np.load(os.path.join(save, "adversarial.ckpt")) as z:
                leaves.append({k: z[k] for k in z.files if k != "__meta__"})
        a, b = leaves
        differ = sorted(k for k in a if k not in b
                        or a[k].tobytes() != b[k].tobytes())
        print(f"two same-seed bf16 training CLI runs on the {name} route: "
              f"{len(a)} checkpoint arrays, {len(differ)} differ in any bit"
              f"{': ' + ', '.join(differ[:5]) if differ else ''}")
        require(a.keys() == b.keys() and not differ,
                f"same-seed bf16 CLI runs on the {name} route wrote "
                f"different checkpoints")
        bn = [k for k in a if "BatchNorm" in k]
        require(bn and all(a[k].dtype == np.float32 for k in bn),
                "the bf16 checkpoint's BatchNorm statistics are not f32")
    return out


def bf16_route_step_card_vs_cpu(name: str, route, pair=None,
                                image=(32, 32, 3), stages: int = 3) -> dict:
    """Phase 32, second part: one bf16 step at batch 8 with augmentation
    on ``route``, on the CPU (the kernels' bf16 plain versions) and on the
    card (their bf16 instantiations) from the same weights and draws:
    the card's launches as designed for one step, and card against CPU
    within phase 28's bounds. ``pair`` makes (G, D) (default: the
    flagship pair, seeded) for ``image``; G has ``stages`` upsample-convs.
    Returns the comparison and the launches."""
    import copy

    import torch
    from catgen_torch import optim
    from catgen_torch.core.random import Draws
    from catgen_torch.kernels import config as upconfig
    from catgen_torch.train import gan

    config = gan.GanConfig(batch_size=8, augment=True,
                           compute_dtype=torch.bfloat16)
    g, d = pair() if pair else seeded_pair(3, G_GAIN, D_GAIN)
    reals = torch.rand((4, *image),
                       generator=torch.Generator().manual_seed(4))
    real_cap = optim.clamp_and_penalize
    runs, recorded, counts = {}, None, None
    mode = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dev in ("cpu", "cuda"):
            gd, dd = copy.deepcopy(g).to(dev), copy.deepcopy(d).to(dev)
            state = gan.init_state(gd, dd, config)
            grads = []

            def spy(gr, *a, **k):
                grads.append({n: t.detach().cpu() for n, t in gr.items()})
                return real_cap(gr, *a, **k)

            draws = (RecordingDraws(Draws(torch.Generator().manual_seed(5)))
                     if dev == "cpu" else ReplayedDraws(recorded.taken, dev))
            optim.clamp_and_penalize = spy
            reset_counts()
            try:
                with upconfig.using(**route):
                    m = gan.make_train_step(gd, dd, config)(
                        state, reals.to(dev), draws)
            finally:
                optim.clamp_and_penalize = real_cap
            if dev == "cpu":
                recorded = draws
            else:
                torch.cuda.synchronize()
                require(not draws.taken, "the card drew less than the CPU")
                counts = bf16_route_counts()
            runs[dev] = (m, grads, _state_tensors(state))
    finally:
        torch.backends.cudnn.deterministic = mode
    want = expected_bf16_route(route, 1, 0, 0, stages)
    print(f"bf16 step on the {name} route, on the card: launches "
          f"{ {k: v for k, v in counts.items() if v} }, expected "
          f"{ {k: v for k, v in want.items() if v} }")
    require(counts == want, f"the bf16 {name} step's kernel launches")
    return {**compare_bf16_steps(runs["cpu"], runs["cuda"],
                                 f"bf16 step on the {name} route"),
            "launches": counts}


def bf16_route_step_times(card_name: str) -> dict:
    """Phase 33, the steps: the bf16 train step at B=640 (bench.py's
    configuration) on the default, ladder, per-layer and fused-prefix
    routes in one run, in that order: time, images/s, peak memory, idle
    share and each port kernel's device time in a profiled step."""
    import torch

    out = {}
    for name, route in (("default", None), ("ladder", LADDER),
                        ("per-layer", PER_LAYER), ("fused-prefix", FUSED)):
        out[name] = bf16_step_times(
            card_name, torch.bfloat16, False, route, name,
            BF16_STEP_DCOORDS["RowsLayout"] if name == "fused-prefix"
            else None)
        torch.cuda.empty_cache()
    base = out["default"]["step_ms"]
    print("bf16 train step, batch 640: " + ", ".join(
        f"{name} route {r['step_ms']:.3f} ms ({r['step_ms'] / base:.3f} of "
        f"the default)" for name, r in out.items())
          + f" (same run, in that order); {card_name}")
    return out


# ---------------------------------------------------------------------------
# the 64px pyramid: G64_stack against D64 (phases 34-36)
# ---------------------------------------------------------------------------

B64 = 256                  # bench.py's 64px training batch
IMG64 = (64, 64, 3)
# the refine trunk's upsample-conv in a G batch of B64: (N, H, W, Cin,
# Cout, k), 32x32x64 -> 64x64x64 with a 5x5 kernel (3x3 collapsed taps)
REFINE_SHAPE = (B64, 32, 32, 64, 64, 5)
# the augmentation of the reals, half of a B64 batch: (N, H, W, C, Ho, Wo)
SAMPLER64_SHAPE = (B64 // 2, 64, 64, 3, 64, 64)
# the 64px kernel route: the base G32up-c as the ladder, the refine
# trunk's upsample-conv per layer (a plain Sequential), both backwards on
# their kernels
ROUTE64 = dict(upsample_impl="pallas", fused_ladder=True,
               ladder_bwd="pallas", upsample_bwd="pallas")
# catgen's documented 64px run (tools/stack64_warmstart.py), 2 epochs of 5
# steps at batch 64 on a fixture corpus
TRAIN64_ARGS = ["--fixture", "256", "--scale", "64", "--G", "g64_stack",
                "--D", "d64", "--augment", "--collapseDetect",
                "--weightsVisFreq", "1", "--epochs", "2", "--batchSize",
                "64", "--N_epoch", "160"]
# G's gradients in a 64px step, card against CPU: f32 rounding may flip
# the PReLU branch of one of the refine trunk's 2^20 pre-activations,
# which moves a weight gradient by ~1e-3 of itself (the CPU parity test's
# finding, tests/test_torch_port_refine64.py)
G64_GRAD_REL = 2e-3
# the profiler names of each launch counter's kernels (bf16_route_counts'
# keys), f32 and bf16
TRACE_NAMES = {
    "LAUNCHES": ("sample_per", "RowsLayout"),
    "BF16_LAUNCHES": ("sample_per", "RowsLayout"),
    "up_LAUNCHES": ("upsample_conv_fwd<false",),
    "up_BLOCK_LAUNCHES": ("upsample_conv_fwd<true",),
    "up_DX_LAUNCHES": ("upsample_conv_dx<false",),
    "up_BLOCK_DX_LAUNCHES": ("upsample_conv_dx<true",),
    "up_DCK_LAUNCHES": ("upsample_conv_dck<false",),
    "up_BLOCK_DCK_LAUNCHES": ("upsample_conv_dck<true",),
    "up_BF16_LAUNCHES": ("upsample_conv_fwd_bf16", "<false"),
    "up_BF16_BLOCK_LAUNCHES": ("upsample_conv_fwd_bf16", "<true"),
    "up_BF16_DX_LAUNCHES": ("upsample_conv_dx_bf16<false",),
    "up_BF16_BLOCK_DX_LAUNCHES": ("upsample_conv_dx_bf16<true",),
    "up_BF16_DCK_LAUNCHES": ("upsample_conv_dck_bf16<",),
    "up_BF16_BLOCK_DCK_LAUNCHES": ("upsample_conv_dck_bf16<",),
    "up_BF16_TRANSFORM_LAUNCHES": ("upsample_conv_transform_bf16",),
    "up_BF16_FOLD_LAUNCHES": ("upsample_conv_fold_bf16",),
}


def seeded64(seed: int):
    """G64_stack and D64 with the flagship's seeded weights (``perturb``
    at the card-against-CPU gains)."""
    from catgen_torch import models

    g = models.create_G64_stack(IMG64, 100)
    d = models.create_D64(IMG64)
    perturb(g, d, seed, G_GAIN, D_GAIN)
    return g, d


def expected64(route, steps: int, g_evals: int, bf16: bool = False) -> dict:
    """``bf16_route_counts`` as the design gives them for ``steps`` train
    steps of G64_stack against D64 with augmentation, in bf16 or f32, and
    ``g_evals`` eval-mode G batches (in f32: the visualization samples in
    f32) on ``route`` (None: the default route). D64 has no spatial
    transformer: a step's one sampler launch is the augmentation's
    forward. On ROUTE64 a G forward runs 3 ladder blocks (the base) and one
    per-layer forward (the refine trunk); a step runs G forward twice
    (the D phase, without gradient, and the G phase) and backward once;
    the bf16 blocks add their transform and fold passes
    (``expected_bf16_route``)."""
    want = dict.fromkeys(bf16_route_counts(), 0)
    want["BF16_LAUNCHES" if bf16 else "LAUNCHES"] = steps
    if route is None:
        return want

    def up(n_steps: int, n_evals: int) -> dict:
        forwards = 2 * n_steps + n_evals
        return {"BLOCK_LAUNCHES": 3 * forwards, "LAUNCHES": forwards,
                "BLOCK_DX_LAUNCHES": 3 * n_steps,
                "BLOCK_DCK_LAUNCHES": 3 * n_steps,
                "DX_LAUNCHES": n_steps, "DCK_LAUNCHES": n_steps}

    stepped = up(steps, 0)
    for k, v in up(0, g_evals).items():
        want[f"up_{k}"] += v
    for k, v in stepped.items():
        want[f"up_BF16_{k}" if bf16 else f"up_{k}"] += v
    if bf16:
        want["up_BF16_TRANSFORM_LAUNCHES"] = (stepped["BLOCK_LAUNCHES"]
                                              + stepped["BLOCK_DCK_LAUNCHES"])
        want["up_BF16_FOLD_LAUNCHES"] = stepped["BLOCK_DCK_LAUNCHES"]
    return want


def refine_vs_plain(bf16: bool = False) -> dict:
    """Phase 34: the per-layer upsample-conv kernels at the refine trunk's
    shape (REFINE_SHAPE; Cin = Cout = 64, so every 128-channel tile runs
    half masked) against their plain versions: the forward's y (bias only,
    as the trunk runs it), the backward's dx, dweight and dbias
    (``output_check``: y and dx tight, the sums over the batch loose),
    each run twice, the repeats bit for bit. In bf16 the forward must take
    the TMA kernel (box (32, 4, 1): one 64-deep contraction step a tap),
    and the profiler must see it. Returns the largest error of each
    kernel and, under "<key>_rel", over the largest plain value."""
    import torch
    from catgen_torch.kernels import fused_upsample_conv as fuc

    v = upsample_inputs(REFINE_SHAPE, 410 + bf16, bf16)
    x, w, b, gy = v["x"], v["weight"], v["bias"], v["gy"]
    n, h, wd, cin, _, _ = REFINE_SHAPE
    tag = f"{REFINE_SHAPE} {'bf16' if bf16 else 'f32'}"
    if bf16:
        run = lambda: fuc.upsample2_conv_fused(x, w, b)  # noqa: E731
        kind = fuc.forward_kind_bf16(x)
        names = [k for k in kernel_names(run)
                 if "upsample_conv_fwd_bf16" in k]
        print(f"{tag} forward: {kind} kernel (box "
              f"{fuc.fwd_bf16_box(n, h, wd, cin)}), the profiler saw "
              f"{names or 'no kernel in 3 sessions'}")
        require(kind == "tma" and (not names or (
            len(names) == 1 and "upsample_conv_fwd_bf16_tma<" in names[0])),
            f"the bf16 forward at the refine shape took {kind}: {names}")
    worst = {}
    for keys, names, kern, plain in (
            (("fwd",), ("y",), lambda: (fuc.upsample2_conv_fused(x, w, b),),
             lambda: (fuc.block_plain(x, w, b),)),
            (("dx", "dck", "dck"), ("dx", "dweight", "dbias"),
             lambda: fuc.upsample2_conv_backward(x, w, gy),
             lambda: fuc.kernel_backward_plain(x, w, gy))):
        got, again = kern(), kern()
        torch.cuda.synchronize()
        for key, name, a, a2, p in zip(keys, names, got, again, plain()):
            err, rel = output_check(f"{tag} {key} {name}", a, a2, p,
                                    loose=name.startswith("d") and
                                    name != "dx")
            worst[key] = max(worst.get(key, 0.0), err)
            worst[f"{key}_rel"] = max(worst.get(f"{key}_rel", 0.0), rel)
    del v, x, w, b, gy
    torch.cuda.empty_cache()
    return worst


def refine_times(card_name: str, bf16: bool = False) -> dict:
    """Phase 34: the per-layer forward, dX and dCK at the refine trunk's
    shape, each against its plain version, cuDNN's collapsed route and
    its bound (``kernel_row``). The bound's work is the collapsed
    product's: 2 x N x 32 x 32 x 4 parities x 9 taps x 64 x 64 flops
    (7.7e10 at N = 256); its bytes each operand read once, each output
    written once."""
    import torch
    from catgen_torch.kernels import fused_upsample_conv as fuc
    from catgen_torch.kernels.upsample_conv import upsample2_conv

    n, h, w, cin, cout, k = REFINE_SHAPE
    v = upsample_inputs(REFINE_SHAPE, 420 + bf16, bf16)
    x, wt, b, gy = v["x"], v["weight"], v["bias"], v["gy"]
    xr, wr = x.detach().requires_grad_(), wt.detach().requires_grad_()
    lib_y = upsample2_conv(xr, wr)
    kp = (k + 1) // 2
    flops = 2.0 * n * h * w * 4 * kp * kp * cin * cout
    elem = x.element_size()
    xb, yb = x.numel() * elem, gy.numel() * elem
    wb = 4 * kp * kp * cin * cout * elem
    ckb = 4 * kp * kp * cin * cout * 4
    runs = {
        "fwd": (lambda: fuc.upsample2_conv_fused(x, wt, b),
                lambda: fuc.block_plain(x, wt, b),
                lambda: upsample2_conv(x, wt), xb + wb + yb),
        "dx": (lambda: fuc.upsample2_conv_dx(x, wt, gy),
               lambda: fuc.kernel_backward_plain(x, wt, gy),
               lambda: torch.autograd.grad(lib_y, [xr], gy,
                                           retain_graph=True),
               yb + wb + xb),
        "dck": (lambda: fuc._launch_dck(x, wt, gy),
                lambda: fuc._kernel_vjp(x, wt, gy, need_x=False),
                lambda: torch.autograd.grad(lib_y, [wr], gy,
                                            retain_graph=True),
                xb + yb + ckb),
    }
    dtype = "bf16" if bf16 else "f32"
    out = {key: kernel_row(f"{dtype} {key} refine {REFINE_SHAPE}", key,
                           kern, plain, library, flops, nbytes, bf16,
                           card_name)
           for key, (kern, plain, library, nbytes) in runs.items()}
    del runs, lib_y, xr, wr, v
    torch.cuda.empty_cache()
    return out


def sampler64(card_name: str) -> dict:
    """Phase 34: the sampler forward on the augmentation's 64x64x3 reals
    (SAMPLER64_SHAPE) at the augmentation's own coordinates, f32 and bf16,
    rows and grid: the kernel each dtype takes (``forward_kind``; the
    image staged in shared memory: 48 KiB in f32, widened to 4 channels
    in bf16), bit for bit against the plain version (per quad or staged;
    within KERNEL_TOL otherwise), repeats bit for bit; times: the kernel
    and its plain version in CUDA events, the kernel's and grid_sample's
    device time, and the bound."""
    import torch
    import torch.nn.functional as F
    from catgen_torch.kernels import bilinear, bilinear_grid

    n, h, w, c, ho, wo = SAMPLER64_SHAPE
    out = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        gen = torch.Generator("cuda").manual_seed(430)
        img = torch.rand((n, h, w, c), generator=gen,
                         device="cuda").to(dtype)
        rows = augment_rows(img, 431)
        grid = rows.permute(0, 2, 1).reshape(n, ho, wo, 2).contiguous()
        kind = bilinear.forward_kind(h, w, c, dtype)
        want = bilinear.bilinear_sample_rows_plain(img, rows, (ho, wo))
        for layout, kern in (
                ("rows", lambda: bilinear.launch(img, rows, (ho, wo))),
                ("grid", lambda: bilinear_grid.launch(img, grid))):
            got, again = kern(), kern()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            exact = torch.equal(got, want)
            print(f"sampler forward {name} {layout} {SAMPLER64_SHAPE}: "
                  f"{kind} kernel, max_abs_err {err:.3e}, bits of the plain "
                  f"version: {exact}, repeat bit-identical: "
                  f"{torch.equal(got, again)}")
            require(exact or (kind not in BIT_EXACT_FORWARDS
                              and err <= KERNEL_TOL),
                    f"the {name} {layout} sampler forward at 64x64x3")
            require(torch.equal(got, again), "the sampler forward repeats")
            out[f"{name}_{layout}_max_abs_err"] = err
        inp = img.permute(0, 3, 1, 2).contiguous()
        xy = grid.flip(-1).contiguous()           # grid_sample takes (x, y)
        kern = lambda: bilinear.launch(img, rows, (ho, wo))  # noqa: E731
        plain = lambda: bilinear.bilinear_sample_rows_plain(  # noqa: E731
            img, rows, (ho, wo))
        library = lambda: F.grid_sample(  # noqa: E731
            inp, xy, mode="bilinear", padding_mode="border",
            align_corners=True)
        k1, p, lib, k2 = (cuda_ms(kern, inner=10), cuda_ms(plain, inner=10),
                          cuda_ms(library, inner=10), cuda_ms(kern, inner=10))
        dev, lib_dev = sampler_device_line(
            "fwd", "rows", SAMPLER64_SHAPE, kern, library, card_name,
            elem=2 if dtype == torch.bfloat16 else 4)
        b_ms, b_by = sampler_bound("fwd", SAMPLER64_SHAPE,
                                   img.element_size())
        out[name] = dict(kind=kind, ms=min(k1, k2), plain_ms=p,
                         library_ms=lib, device_ms=dev,
                         library_device_ms=lib_dev, bound_ms=b_ms,
                         bound_by=b_by)
        print(f"sampler forward {name} {SAMPLER64_SHAPE}: kernel "
              f"{min(k1, k2):.4f} ms ({k1:.4f} / {k2:.4f}), plain {p:.4f} "
              f"ms, grid_sample {lib:.4f} ms (CUDA events, median of 20 "
              f"timings of 10 back-to-back calls), bound {b_ms:.4f} ms "
              f"({b_by}); {card_name}")
        del img, rows, grid, inp, xy, want
    return out


def trace_kernels(trace_dir: str) -> set:
    """The kernel names in the one Chrome trace under ``trace_dir``."""
    files = os.listdir(trace_dir)
    require(len(files) == 1 and files[0].endswith(".trace.json"),
            f"the profile directory holds {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def train64_on_card(save: str, route=None, bf16: bool = False) -> dict:
    """Phase 35: catgen's 64px run through the training CLI on the card
    (TRAIN64_ARGS: G64_stack against D64, augmented, with the collapse
    detector, activation grids at every visualization and a profiled
    second epoch), on the default route or ROUTE64, in f32 or bf16: the
    launches of every kernel as ``expected64`` gives them (3
    visualizations: before each epoch and the detector's look after the
    last), a completed run (no collapse.json), the activation grids, the
    trace naming each kernel the profiled epoch launched, and the sample
    CLI reading the checkpoint on the card. Returns the counts and
    steps."""
    from catgen_torch.cli import sample as sample_cli
    from catgen_torch.cli import train as train_cli
    from catgen_torch.kernels import config as upconfig

    trace = os.path.join(save, "trace")
    name = (f"{'bf16' if bf16 else 'f32'} "
            f"{'kernel' if route else 'default'} route")
    reset_counts()
    t0 = time.perf_counter()
    with upconfig.using(**(route or {})):
        harness = train_cli.main(
            TRAIN64_ARGS + ["--device", "cuda", "--save", save, "--profile",
                            trace] + (["--dtype", "bf16"] if bf16 else []))
    seconds = time.perf_counter() - t0
    counts, steps = bf16_route_counts(), harness.state.step
    want = expected64(route, steps, 3, bf16)
    shown = {k: v for k, v in counts.items() if v or want[k]}
    print(f"64px training CLI, {name}: {steps} steps, 3 visualizations, "
          f"{seconds:.1f} s; launches {shown}, expected "
          f"{ {k: want[k] for k in shown} }")
    require(steps == 10 and counts == want,
            f"the 64px training CLI's launches on the {name}")
    require(harness.collapse is not None and harness.collapse.verdict is None
            and not os.path.exists(os.path.join(save, "collapse.json")),
            "the 64px run did not complete")
    with open(os.path.join(save, "train_metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    epochs = [e for e in events if e["event"] == "epoch"]
    require(len(epochs) == 2 and all(math.isfinite(e[k]) for e in epochs
                                     for k in ("loss_d", "loss_g")),
            "the 64px run's epochs")
    print(f"  epochs: " + "; ".join(
        f"loss_d {e['loss_d']:.5f} loss_g {e['loss_g']:.5f} acc_d "
        f"{e['acc_d']:.4f}" for e in epochs))
    for epoch in (1, 2, 3):
        grids = os.listdir(os.path.join(save, "activations",
                                        f"epoch_{epoch:06d}"))
        require(len(grids) == 28, f"{len(grids)} activation grids of D64")
    names = trace_kernels(trace)
    traced = {k: any(all(p in n for p in TRACE_NAMES[k]) for n in names)
              for k, v in expected64(route, 1, 0, bf16).items() if v}
    print(f"  the trace of epoch 2 ({len(names)} kernel names) names "
          f"{traced}")
    require(all(traced.values()), "a kernel of the step is not in the trace")
    with upconfig.using(**(route or {})):
        runs = sample_cli.main(["--save", save, "--count", "256",
                                "--device", "cuda", "--neighbours"])
    check_finite(runs[0])
    require(tuple(runs[0]["images"].shape) == (256,) + IMG64
            and runs[0]["images"].is_cuda, "the 64px samples")
    print(f"  sample CLI read the 64px checkpoint on the card: 256 images, "
          f"D scores {runs[0]['scores'].min().item():.4f}..."
          f"{runs[0]['scores'].max().item():.4f}")
    return {"launches": counts, "steps": steps, "seconds": seconds,
            "events": events}


def warmstart64(ckpt32: str, save: str) -> None:
    """Phase 35: ``cli.stack64_warmstart`` grafts a 32px run's G (phase
    8's checkpoint) into a fresh G64_stack under the pickup filename;
    its base leaves are the 32px G's, bit for bit."""
    import numpy as np
    from catgen_torch.cli import stack64_warmstart

    out = stack64_warmstart.main(["--ckpt", ckpt32, "--save", save])
    with np.load(ckpt32) as a, np.load(out) as b:
        src = {k[len(".g_params"):]: a[k] for k in a.files
               if k.startswith(".g_params")}
        dst = {k[len("['params']['00_G32up_c']"):]: b[k] for k in b.files
               if k.startswith("['params']['00_G32up_c']")}
        same = src.keys() == dst.keys() and all(
            np.array_equal(src[k], dst[k]) for k in src)
    print(f"warm start {out}: {len(dst)} base parameter arrays, the 32px "
          f"run's bits: {same}")
    require(same, "the warm start's base is not the 32px run's G")


def steps64_card_vs_cpu() -> dict:
    """Phase 36: one 64px step at batch 8, card against CPU, on the
    default route and on ROUTE64 (``step_card_vs_cpu``; G's gradients
    within G64_GRAD_REL)."""
    return {name: step_card_vs_cpu(
        route, pair=lambda: seeded64(3), image=IMG64,
        expected=lambda r: expected64(r, 1, 0), g_rel=G64_GRAD_REL)
        for name, route in (("default", None), ("kernel", ROUTE64))}


def step64_times(card_name: str) -> dict:
    """Phase 36: bench.py's 64px step (G64_stack against D64, batch 256,
    augmented) in f32 and bf16 on the default route and ROUTE64, in one
    run (``bf16_step_times``: median of 10 with min and max, images/s,
    peak memory, idle share, each port kernel's device time)."""
    import torch

    out = {}
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for rname, route in (("default", None), ("kernel", ROUTE64)):
            out[f"{dname}_{rname}"] = bf16_step_times(
                card_name, dtype, False, route, f"64px {rname}",
                pair=lambda: seeded64(6), batch=B64, image=IMG64)
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the 16px workflow, the rest of the model zoo and the quality evaluation
# (phases 37-39)
# ---------------------------------------------------------------------------

IMG16 = (16, 16, 3)
# the upsample-convs the new Gs give the kernels in a G batch of 640, (N,
# H, W, Cin, Cout, k): G16up's two stages, then G32up's first (its second
# is G32up-c's third, and G32up-b's stages are G32up-c's); Cin = 128 with
# k5 and a k5 conv from a 4x4 image are new; the bf16 forward's TMA boxes
# of x (w, h, n) hold 8, 2 and 2 images
NEW_STAGES = [(TRAIN_B, 4, 4, 128, 256, 5), (TRAIN_B, 8, 8, 256, 128, 5),
              (TRAIN_B, 8, 8, 128, 256, 5)]
NEW_BOXES = ((4, 4, 8), (8, 8, 2), (8, 8, 2))
G16UP_STAGES, G32UP_STAGES = NEW_STAGES[:2], NEW_STAGES[2:]
# the sampler in a 16px D batch of 640: the input ST, and D32_st3's three
# branch STs stacked (its stem pools the input to 8x8); D16_st3's branches
# sample 16x16x64 images, TRAIN_SHAPES[1]; the augmentation samples half
# a batch at the input ST's shape, at its own coordinates
SAMPLER16_SHAPES = [(TRAIN_B, 16, 16, 3, 16, 16), (TRAIN_B, 8, 8, 64, 24, 8)]
# the kernels they take: (forward, d_coords, d_img) by dtype
SAMPLER16_KINDS = {
    "f32": (("per_quad", "per_pixel", "per_sample"),
            ("staged", "staged", "gather")),
    "bf16": (("per_quad", "per_quad", "per_sample"),
             ("staged", "staged", "gather"))}
# the ST-conv prefix at 16px, (N, H, W, C, F): 256 pixels a sample, in a
# training D batch and in a sampling D batch
ST16_SHAPES = [(TRAIN_B, 16, 16, 3, 64), (N_SAMPLER, 16, 16, 3, 64)]
# catgen's 16px run: 2 epochs of 5 steps at batch 64, augmented
TRAIN16_ARGS = ["--fixture", "256", "--scale", "16", "--augment",
                "--epochs", "2", "--batchSize", "64", "--N_epoch", "160"]
V16_ARGS = ["--fixture", "256", "--scale", "16", "--epochs", "1",
            "--batchSize", "32", "--N_epoch", "160"]
# the V run's overlay bank at catgen's test size (tests/test_v_subsystem.py)
# in place of the full 1000 x 10000 walk, which phase 22 builds
V16_BANK = dict(n=8, n_points=500)
# G16up against D32_st3 on every route of ROUTES16; against D16_st3 on
# the default route (its kernel shapes are D32_st3's: the prefix at 16x16,
# the branches at 16x16x64, which phases 8-33 run at 32px)
PAIRS16 = (("g16up", "default"), ("g16up", "d16_st3"))
ROUTES16 = (("default", None), ("ladder", LADDER), ("fused-prefix", FUSED))
STEP16_ROUTES = ROUTES16 + (("per-layer", PER_LAYER),)
# one step on the card of every other new registry key, at its scale:
# (G, D, image side); the Gs against D32_st3, the Ds against the default G
ZOO_STEPS = (("g32up", "d32_st3", 32), ("g32up_b", "d32_st3", 32),
             ("mlp", "d32_st3", 32), ("g16up", "d16", 16),
             ("g16up", "d16b", 16), ("g32up_c", "d32", 32),
             ("g32up_c", "d32b", 32), ("g32up_c", "d32c", 32),
             ("g32up_c", "d32d", 32), ("g32up_c", "d32e", 32))
# upsample-conv stages of each G
G_STAGES_OF = {"g16up": 2, "g32up": 2, "g32up_b": 3, "g32up_c": 3,
               "mlp": 0}
QUALITY_SAMPLES = 1024     # catgen's eval_quality default (sample.lua's)
# the quality report, card against CPU: D scores and V ratings within
# the CPU parity test's 1e-5 absolute and diversity within its 1e-4
# relative (tests/test_torch_port_quality.py); NN distances within phase
# 6's card-against-CPU NN_RTOL: a distance is the square root of ||a||^2
# + ||b||^2 - 2 a.b from one f32 matmul, whose rounding (cuBLAS's order
# against the CPU's) scales with the norms, not with the distance (2.7e-5
# of a distance of 3.9 between fixture images, against 7e-7 of 16 in the
# CPU test's random images). A value within its tolerance of a histogram
# edge may fall on either side: at most HIST_MOVES values move between
# neighbouring bins
QUALITY_SCORE_ATOL, QUALITY_DIV_RTOL, HIST_MOVES = 1e-5, 1e-4, 3


def seeded16(g_name: str, d_name: str, seed: int, image=IMG16):
    """The registry pair (``g_name``, ``d_name``) at ``image`` with the
    flagship's seeded weights (``perturb`` at the card-against-CPU
    gains)."""
    from catgen_torch import models

    g = models.G_REGISTRY[g_name](image, 100)
    d = models.D_REGISTRY[d_name](image)
    perturb(g, d, seed, G_GAIN, D_GAIN)
    return g, d


def new_stages_vs_plain(bf16: bool, shapes) -> dict:
    """Phase 37: the upsample-conv kernels at the new Gs' ``shapes``
    against their plain versions (``upsample_vs_plain``: every form, the
    repeats bit for bit) and against float64 (f32: the forward, dX and
    dCK, ``F64_TOL`` and ``UP_TIGHT``; bf16: dCK within one unit + 2^-16
    of float64 rounded once); in bf16 also the block's passes and the
    forward's kernel: the TMA kernel with the box NEW_BOXES gives, and
    the cp.async kernel for x off a 16-byte boundary."""
    from catgen_torch.kernels import fused_upsample_conv as fuc

    for shape in shapes:
        box = NEW_BOXES[NEW_STAGES.index(shape)]
        got = fuc.fwd_bf16_box(*shape[:4])
        print(f"{shape}: the bf16 forward's box of x {got} (designed {box})")
        require(got == box, f"the bf16 forward's box at {shape}")
    out = upsample_vs_plain(bf16, shapes)
    if bf16:
        out["passes"] = passes_vs_plain(shapes)
        out["kinds"] = bf16_forward_kinds(
            shapes, [("x off 16 bytes", shapes[0])])
        out["vs_float64"] = dck_vs_float64(True, shapes, plant=False)
    else:
        out["vs_float64"] = {**fwd_vs_float64(shapes),
                             **dck_vs_float64(False, shapes),
                             **dx_vs_float64(shapes)}
    return out


def sampler16(card_name: str) -> dict:
    """Phase 37: the sampler kernels at the 16px shapes (SAMPLER16_SHAPES,
    and the augmentation of half a batch at its own coordinates), f32 and
    bf16: the kernel each takes (SAMPLER16_KINDS), the forward against
    the plain version (bit for bit where it runs per quad or staged, and
    in bf16; else within KERNEL_TOL), d_img and d_coords against the plain
    version's (f32: BWD_ATOL + BWD_RTOL of the largest; bf16: BF16_ULPS
    unit + BF16_FLOOR of the largest), every kernel twice, the repeats
    bit for bit. At SAMPLER16_SHAPES each kernel is timed against its
    plain version and its library call (CUDA events), in device time
    (the kernel's, one profiled session) and against its bound. Returns
    the largest errors and the rows by dtype and shape."""
    import torch
    import torch.nn.functional as F
    from catgen_torch.kernels import bilinear

    out = {}
    half = (TRAIN_B // 2,) + SAMPLER16_SHAPES[0][1:]
    cases = ([(shape, False) for shape in SAMPLER16_SHAPES]
             + [(half, True)])
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        worst = {"fwd": 0.0, "dcoords": 0.0, "dimg": 0.0}
        rows_out = {}
        for i, (shape, augment) in enumerate(cases):
            n, h, w, c, ho, wo = shape
            kinds = (bilinear.forward_kind(h, w, c, dtype),
                     bilinear.dcoords_kind(h, w, c, dtype),
                     bilinear.dimg_kind(h, w, c, dtype))
            want_kinds = SAMPLER16_KINDS[dname][0 if augment else i]
            tag = f"{dname} {shape}{' augmentation' if augment else ''}"
            print(f"sampler kernels at {tag}: forward {kinds[0]}, d_coords "
                  f"{kinds[1]}, d_img {kinds[2]} (designed "
                  f"{', '.join(want_kinds)})")
            require(kinds == want_kinds, f"the sampler kernels at {tag}")
            img, rows, out_hw = sampler_inputs(shape, 500 + i)
            gen = torch.Generator().manual_seed(510 + i)
            g = (torch.rand((n, ho, wo, c), generator=gen) * 2 - 1).cuda()
            img, g = img.to(dtype), g.to(dtype)
            rows = augment_rows(img, 520 + i) if augment else rows.to(dtype)
            fwd = [bilinear.launch(img, rows, out_hw) for _ in range(2)]
            dimg = [bilinear.launch_dimg(img, rows, g, out_hw)
                    for _ in range(2)]
            dcrd = [bilinear.launch_dcoords(img, rows, g, out_hw)
                    for _ in range(2)]
            torch.cuda.synchronize()
            want_fwd = bilinear.bilinear_sample_rows_plain(img, rows, out_hw)
            want_img, want_crd = bilinear.bilinear_sample_rows_backward_plain(
                img, rows, g, out_hw)
            err = (fwd[0].float() - want_fwd.float()).abs().max().item()
            exact = torch.equal(fwd[0], want_fwd)
            bits = dtype == torch.bfloat16 or kinds[0] in BIT_EXACT_FORWARDS
            print(f"{tag} forward: max_abs_err {err:.3e}, the plain "
                  f"version's bits: {exact}{' (required)' if bits else ''}; "
                  f"repeat bit-identical: {torch.equal(*fwd)}")
            require(exact if bits else err <= KERNEL_TOL,
                    f"the forward at {tag}")
            require(torch.equal(*fwd), f"the forward repeats at {tag}")
            worst["fwd"] = max(worst["fwd"], err)
            for name, (a, a2), b in (("dimg", dimg, want_img),
                                     ("dcoords", dcrd, want_crd)):
                require(a.dtype == b.dtype and a.shape == b.shape,
                        f"{name} at {tag}: {a.dtype} {tuple(a.shape)}")
                e = (a.float() - b.float()).abs()
                top = b.float().abs().max().item()
                if dtype == torch.bfloat16:
                    ok = bool((e <= BF16_ULPS * bf16_spacing(b)
                               + BF16_FLOOR * top).all())
                    rule = f"{BF16_ULPS} unit + {BF16_FLOOR:g} x max"
                else:
                    ok = e.max().item() <= BWD_ATOL + BWD_RTOL * top
                    rule = f"{BWD_ATOL} + {BWD_RTOL} x max"
                same = torch.equal(a, a2)
                print(f"{tag} {name}: max_abs_err {e.max().item():.3e} "
                      f"(max |plain| {top:.4f}; within {rule}: {ok}); repeat "
                      f"bit-identical: {same}")
                require(ok and same, f"{name} at {tag}")
                worst[name] = max(worst[name], e.max().item())
            if augment:
                continue
            inp = img.permute(0, 3, 1, 2).contiguous()
            gn = g.permute(0, 3, 1, 2).contiguous()
            grid = torch.stack([rows[:, 1], rows[:, 0]], dim=-1).reshape(
                n, ho, wo, 2).contiguous()

            def grid_bwd(mask, gn=gn, inp=inp, grid=grid):
                return torch.ops.aten.grid_sampler_2d_backward(
                    gn, inp, grid, 0, 1, True, mask)

            bwd_plain = bilinear.bilinear_sample_rows_backward_plain
            runs = {
                "fwd": (lambda: bilinear.launch(img, rows, out_hw),
                        lambda: bilinear.bilinear_sample_rows_plain(
                            img, rows, out_hw),
                        lambda: F.grid_sample(inp, grid, mode="bilinear",
                                              padding_mode="border",
                                              align_corners=True)),
                "dcoords": (lambda: bilinear.launch_dcoords(img, rows, g,
                                                            out_hw),
                            lambda: bwd_plain(img, rows, g, out_hw,
                                              need_img=False),
                            lambda: grid_bwd([False, True])),
                "dimg": (lambda: bilinear.launch_dimg(img, rows, g, out_hw),
                         lambda: bwd_plain(img, rows, g, out_hw,
                                           need_coords=False),
                         lambda: grid_bwd([True, False]))}
            elem = img.element_size()
            for key, (kern, plain, library) in runs.items():
                k1, p = cuda_ms(kern, inner=10), cuda_ms(plain, inner=10)
                lib, k2 = cuda_ms(library, inner=10), cuda_ms(kern, inner=10)
                dev, lib_dev = device_ms(kern)[0], None
                b_ms, b_by = sampler_bound(key, shape, elem)
                rows_out[f"{key} {shape}"] = dict(
                    kind=kinds[("fwd", "dcoords", "dimg").index(key)],
                    ms=min(k1, k2), plain_ms=p, library_ms=lib,
                    device_ms=dev, library_device_ms=lib_dev, bound_ms=b_ms,
                    bound_by=b_by)
                print(f"{dname} {key} {shape}: kernel {min(k1, k2):.4f} ms "
                      f"({k1:.4f} / {k2:.4f}), device {dev:.4f} ms, plain "
                      f"{p:.4f} ms, {SAMPLER_LIBRARY[key]} {lib:.4f} ms "
                      f"(CUDA events, median of 20 timings of 10 "
                      f"back-to-back calls, order kernel-plain-library-"
                      f"kernel; the kernel's device time from a profiled "
                      f"session of >= 100 calls), bound "
                      f"{b_ms:.4f} ms ({b_by}); {card_name}")
            del runs, inp, gn, grid
        out[dname] = {"max_abs_err": worst, "rows": rows_out}
        torch.cuda.empty_cache()
    return out


def base64_block_rows(card_name: str, bf16: bool) -> dict:
    """Phase 37, for the 64px table: rows 4 and 6 at G64_stack's base
    stages (G32up-c's, B=256): the block forward with the BatchNorm sums
    (``upsample2_conv_block_fused``) against its plain version and cuDNN's
    collapsed route with the input transform and the sums (the transform
    in PyTorch, cuDNN's collapsed convolution, the bias, the two sums);
    the block backward in one call (``fused_block_backward``) against its
    plain version and cuDNN's dgrad and wgrad in one call; each beside its
    bound (``kernel_row``; the library in CUDA events alone). Returns
    {"block": [...], "block_backward": [...]} by stage."""
    import torch
    from catgen_torch.kernels import fused_upsample_conv as fuc
    from catgen_torch.kernels.upsample_conv import upsample2_conv

    out = {"block": [], "block_backward": []}
    dtype = "bf16" if bf16 else "f32"
    for s in range(3):
        shape = stage_shape(s, B64)
        n, h, w, cin, cout, k = shape
        v = upsample_inputs(shape, 440 + 10 * bf16 + s, bf16)
        x, wt, b, gy = v["x"], v["weight"], v["bias"], v["gy"]
        sc, sh, al = v["scale"], v["shift"], v["alpha"]
        y = fuc.block_plain(x, wt, b, sc, sh, al)
        xr, wr = x.detach().requires_grad_(), wt.detach().requires_grad_()
        lib_y = upsample2_conv(xr, wr)
        args = (x, sc, sh, al, wt, y, gy, v["gs1"], v["gs2"])

        def lib_block(x=x, wt=wt, b=b, sc=sc, sh=sh, al=al):
            z = upsample2_conv(fuc.block_input(x, sc, sh, al), wt) + b
            zf = z.float()
            return z, zf.sum(dim=(0, 1, 2)), (zf * zf).sum(dim=(0, 1, 2))

        kp = (k + 1) // 2
        flops = 2.0 * n * h * w * 4 * kp * kp * cin * cout
        elem = x.element_size()
        xb, yb = x.numel() * elem, gy.numel() * elem
        wb = 4 * kp * kp * cin * cout * elem
        ckb = 4 * kp * kp * cin * cout * 4
        out["block"].append(kernel_row(
            f"{dtype} block (row 4) G64_stack base stage {s + 1} {shape}",
            "block_sums",
            lambda: fuc.upsample2_conv_block_fused(x, wt, b, sc, sh, al),
            lambda: fuc.block_plain(x, wt, b, sc, sh, al, with_stats=True),
            lib_block, flops, xb + wb + yb, bf16, card_name, False))
        out["block_backward"].append(kernel_row(
            f"{dtype} block backward (row 6, one call) G64_stack base stage "
            f"{s + 1} {shape}", "block_backward",
            lambda: fuc.fused_block_backward(*args),
            lambda: fuc.block_backward_plain(*args),
            lambda: torch.autograd.grad(lib_y, [xr, wr], gy,
                                        retain_graph=True),
            2 * flops, 2 * xb + 2 * yb + wb + ckb, bf16, card_name, False))
        del v, x, wt, b, gy, y, xr, wr, lib_y, args
        torch.cuda.empty_cache()
    return out


def expected16(route, steps: int, g_evals: int, d_evals: int,
               bf16: bool = False, stages: int = 2) -> dict:
    """``bf16_route_counts`` as the design gives them for ``steps`` 16px
    train steps with augmentation on ``route`` (None: the default) in f32
    or bf16, with ``g_evals`` G and ``d_evals`` D batches in f32 (the
    visualization), for a G of ``stages`` upsample-convs and a D with
    D*_st3's spatial transformers (``expected_sampler``)."""
    if bf16:
        return expected_bf16_route(route or {}, steps, g_evals, d_evals,
                                   stages)
    up = expected_upsample(route, steps, g_evals, stages)
    d = expected_sampler(route, steps, d_evals)
    want = dict.fromkeys(bf16_route_counts(), 0)
    want.update({f"up_{k}": v for k, v in up.items()},
                LAUNCHES=d["fwd"], DCOORDS_LAUNCHES=d["dcoords"],
                DIMG_LAUNCHES=d["dimg"], st_conv=d["st_conv"])
    return want


# the profiler names of the sampler's backward and the ST-conv kernels, by
# launch counter, beside phase 35's TRACE_NAMES
TRACE16_NAMES = {
    **TRACE_NAMES,
    "DCOORDS_LAUNCHES": ("dcoords_", "RowsLayout"),
    "BF16_DCOORDS_LAUNCHES": ("dcoords_", "RowsLayout"),
    "DIMG_LAUNCHES": ("dimg_", "RowsLayout"),
    "BF16_DIMG_LAUNCHES": ("dimg_", "RowsLayout"),
    "st_conv": ("st_conv",), "st_conv_bf16": ("st_conv",)}


def train16_on_card(save: str, g_name: str, d_name: str, route,
                    bf16: bool) -> dict:
    """Phase 38: catgen's 16px run through the training CLI on the card
    (TRAIN16_ARGS, ``--G g_name --D d_name``, a profiled second epoch) on
    ``route`` in f32 or bf16: every launch as ``expected16`` gives it (2
    visualizations, in f32), finite epochs, the trace naming every kernel
    the step launches, and the sample CLI reading the checkpoint on the
    card. Returns the launches, steps and seconds."""
    from catgen_torch.cli import sample as sample_cli
    from catgen_torch.cli import train as train_cli
    from catgen_torch.kernels import config as upconfig

    trace = os.path.join(save, "trace")
    name = (f"{g_name} vs {d_name}, {'bf16' if bf16 else 'f32'} "
            f"{'default' if route is None else 'kernel'} route {route}")
    reset_counts()
    t0 = time.perf_counter()
    with upconfig.using(**(route or {})):
        harness = train_cli.main(
            TRAIN16_ARGS + ["--G", g_name, "--D", d_name, "--device", "cuda",
                            "--save", save, "--profile", trace]
            + (["--dtype", "bf16"] if bf16 else []))
    seconds = time.perf_counter() - t0
    counts, steps = bf16_route_counts(), harness.state.step
    want = expected16(route, steps, 2, 4, bf16, G_STAGES_OF[g_name])
    shown = {k: v for k, v in counts.items() if v or want[k]}
    print(f"16px training CLI, {name}: {steps} steps, 2 visualizations, "
          f"{seconds:.1f} s; launches {shown}, expected "
          f"{ {k: want[k] for k in shown} }")
    require(steps == 10 and counts == want,
            f"the 16px training CLI's launches, {name}")
    with open(os.path.join(save, "train_metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    epochs = [e for e in events if e["event"] == "epoch"]
    require(len(epochs) == 2 and all(math.isfinite(e[k]) for e in epochs
                                     for k in ("loss_d", "loss_g")),
            f"the 16px run's epochs, {name}")
    print("  epochs: " + "; ".join(
        f"loss_d {e['loss_d']:.5f} loss_g {e['loss_g']:.5f} acc_d "
        f"{e['acc_d']:.4f}" for e in epochs))
    names = trace_kernels(trace)
    traced = {k: any(all(p in n for p in TRACE16_NAMES[k]) for n in names)
              for k, v in expected16(route, 1, 0, 0, bf16,
                                     G_STAGES_OF[g_name]).items() if v}
    print(f"  the trace of epoch 2 ({len(names)} kernel names) names "
          f"{traced}")
    require(all(traced.values()), "a kernel of the 16px step is not in the "
                                  "trace")
    with upconfig.using(**(route or {})):
        runs = sample_cli.main(["--save", save, "--count", "256",
                                "--device", "cuda", "--neighbours"])
    check_finite(runs[0])
    require(tuple(runs[0]["images"].shape) == (256,) + IMG16
            and runs[0]["images"].is_cuda, "the 16px samples")
    print(f"  sample CLI read the 16px checkpoint on the card: 256 images, "
          f"D scores {runs[0]['scores'].min().item():.4f}..."
          f"{runs[0]['scores'].max().item():.4f}")
    return {"launches": counts, "steps": steps, "seconds": seconds,
            "events": [e["event"] for e in events]}


def workflow16_on_card(root: str) -> dict:
    """Phase 38: cli.train_v --scale 16 (V16, the bank at V16_BANK) in the
    default route's f32 --save, cli.pretrain_g --scale 16 there and in the
    ladder route's (``pretrain_cli_on_card``), then ``train16_on_card``
    for G16up against D32_st3 on each route of ROUTES16 and against
    D16_st3 on the default route, in f32 and bf16;
    the first two G16up runs pick up the pretrained G, the default route's
    V too. Returns the runs' launches by name, and the V run's grid
    forward launches under "v16"."""
    from catgen_torch.cli import train_v as train_v_cli
    from catgen_torch.io import checkpoint
    from catgen_torch.kernels import bilinear_grid
    from catgen_torch.train import harness as tharness
    from catgen_torch.train import synthetic, v_trainer

    runs = {}
    for g_name, d_name in PAIRS16:
        for bf16 in (False, True):
            for rname, route in (ROUTES16 if d_name == "default"
                                 else ROUTES16[:1]):
                key = (f"{d_name}_{'bf16' if bf16 else 'f32'}_"
                       f"{rname.replace('-', '_')}")
                save = os.path.join(root, key)
                first = d_name == "default" and not bf16
                if first and rname == "default":
                    reset_counts()
                    bank, tharness.OVERLAY_BANK = (tharness.OVERLAY_BANK,
                                                   V16_BANK)
                    try:
                        v = train_v_cli.main(V16_ARGS + [
                            "--device", "cuda", "--save", save])
                    finally:
                        tharness.OVERLAY_BANK = bank
                    warps = (sum(v_trainer.warp_batches(*c)
                                 for c in v.choices)
                             + v.factory.branches.count(synthetic.WARP))
                    got = bilinear_grid.launches()["LAUNCHES"]
                    print(f"16px V run (V16, bank {V16_BANK}): "
                          f"{v.state.step} steps, {got} grid forward "
                          f"launches for {warps} warp batches")
                    require(got == warps and os.path.exists(os.path.join(
                        save, checkpoint.v_filename(3, 16, 16))),
                        "the 16px V run")
                    runs["v16"] = {"grid_launches": got,
                                   "steps": v.state.step}
                if first and rname in ("default", "ladder"):
                    pretrain_cli_on_card(save, route, scale=16)
                run = train16_on_card(save, g_name, d_name, route, bf16)
                picked = run.pop("events")[:3]
                if first and rname in ("default", "ladder"):
                    print(f"  picked up: {picked}")
                    require("pretrained_g_loaded" in picked and (
                        rname != "default" or "v_loaded" in picked),
                        f"the 16px run did not pick up its files: {picked}")
                runs[key] = run
    return runs


def steps16_card_vs_cpu() -> dict:
    """Phase 38: one 16px step at batch 8 (G16up against D32_st3), card
    against CPU, on each route of STEP16_ROUTES: f32 within phase 9's
    bounds (``step_card_vs_cpu``), bf16 within phase 28's
    (``bf16_route_step_card_vs_cpu``); the card's launches as designed."""
    out = {}
    for rname, route in STEP16_ROUTES:
        out[f"f32_{rname}"] = step_card_vs_cpu(
            route, pair=lambda: seeded16("g16up", "default", 3),
            image=IMG16, expected=lambda r: expected16(r, 1, 0, 0))
        out[f"bf16_{rname}"] = bf16_route_step_card_vs_cpu(
            f"16px {rname}", route or {},
            pair=lambda: seeded16("g16up", "default", 3), image=IMG16,
            stages=2)
    return out


def zoo_steps_on_card() -> dict:
    """Phase 38: one train step at batch 64 with augmentation on the card
    for each pair of ZOO_STEPS, from seeded weights: finite losses; the
    Gs' steps on the ladder and on the per-layer route launch their
    stages' kernels as designed (``expected_upsample``), the Ds' steps on
    the default route launch the augmentation's sampler forward alone
    (the conv Ds have no spatial transformer). Returns each step's
    launches."""
    import torch
    from catgen_torch.core.random import Draws
    from catgen_torch.kernels import config as upconfig
    from catgen_torch.train import gan

    out = {}
    for g_name, d_name, side in ZOO_STEPS:
        image = (side, side, 3)
        routes = ((("ladder", LADDER), ("per-layer", PER_LAYER))
                  if d_name == "d32_st3" else (("default", None),))
        for rname, route in routes:
            g, d = seeded16(g_name, d_name, 7, image)
            g, d = g.cuda(), d.cuda()
            config = gan.GanConfig(batch_size=64, augment=True)
            state = gan.init_state(g, d, config)
            reals = torch.rand((32, *image), device="cuda")
            reset_counts()
            with upconfig.using(**(route or {})):
                m = gan.make_train_step(g, d, config)(
                    state, reals, Draws(torch.Generator("cuda").manual_seed(
                        8)))
            torch.cuda.synchronize()
            up, dk = upsample_counts(), sampler_counts()
            want_up = expected_upsample(route, 1, 0, G_STAGES_OF[g_name])
            want_d = (expected_sampler(None, 1, 0) if d_name == "d32_st3"
                      else {**{k: 0 for k in dk}, "fwd": 1})
            losses = (float(m.loss_d), float(m.loss_g))
            print(f"{g_name} vs {d_name} at {side}px, {rname} route: losses "
                  f"{losses[0]:.5f} / {losses[1]:.5f}; upsample-conv "
                  f"{ {k: v for k, v in up.items() if v} } (expected "
                  f"{ {k: v for k, v in want_up.items() if v} }); D's "
                  f"kernels { {k: v for k, v in dk.items() if v} }")
            require(all(map(math.isfinite, losses)),
                    f"{g_name} vs {d_name}: non-finite losses")
            require(up == want_up and dk == want_d,
                    f"{g_name} vs {d_name}: the step's launches")
            out[f"{g_name}_{d_name}_{rname}"] = {
                "loss_d": losses[0], "loss_g": losses[1],
                "launches": {**{f"up_{k}": v for k, v in up.items()}, **dk}}
            del g, d, state
    return out


def step16_times(card_name: str) -> dict:
    """Phase 38: the 16px step (G16up against D32_st3, batch 640,
    augmented) in f32 and bf16 on the default and ladder routes, in one
    run (``bf16_step_times``: median of 10 with min and max, images/s,
    peak memory, idle share, each port kernel's device time)."""
    import torch

    out = {}
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for rname, route in (("default", None), ("ladder", LADDER)):
            out[f"{dname}_{rname}"] = bf16_step_times(
                card_name, dtype, False, route, f"16px {rname}",
                pair=lambda: seeded16("g16up", "default", 6), batch=TRAIN_B,
                image=IMG16)
            torch.cuda.empty_cache()
    return out


def write_corpus(root: str, n: int, parts: int = 8) -> list:
    """``n`` fixture images in ``parts`` directories written by as many
    worker processes (one seed each); returns the directories."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from catgen_torch.data.fixture import write_fixture_dataset

    dirs = [os.path.join(root, f"part{i}") for i in range(parts)]
    with ProcessPoolExecutor(
            parts, mp_context=multiprocessing.get_context("spawn")) as ex:
        list(ex.map(write_fixture_dataset, dirs, [n // parts] * parts,
                    [64] * parts, range(parts)))
    return dirs


def moved_values(a: list, b: list) -> int:
    """The fewest values that, each moved to a neighbouring bin, turn the
    histogram counts ``b`` into ``a`` (-1 if the totals differ)."""
    carry = moved = 0
    for x, y in zip(a, b):
        carry += x - y         # values that crossed the edge after this bin
        moved += abs(carry)
    return moved if carry == 0 else -1


def reports_agree(card: dict, cpu: dict) -> dict:
    """The card's quality report against the CPU's, field by field, within
    QUALITY_SCORE_ATOL, QUALITY_DIV_RTOL, NN_RTOL and HIST_MOVES; returns
    the largest differences and the histograms' moved values."""
    import numpy as np

    worst = {}

    def close(key, a, b, atol=0.0, rtol=0.0):
        err = abs(a - b)
        worst[key] = max(worst.get(key, 0.0), err)
        require(err <= atol + rtol * abs(b),
                f"quality report {key}: card {a!r} against CPU {b!r}")

    for k in ("n_samples", "corpus_size", "image_shape", "finite",
              "checkpoint", "epoch"):
        require(card[k] == cpu[k], f"quality report {k}")
    for k, atol, rtol in (("d_scores_generated", QUALITY_SCORE_ATOL, 0.0),
                          ("d_scores_real", QUALITY_SCORE_ATOL, 0.0),
                          ("nn_l2", 0.0, NN_RTOL)):
        a, b = card[k], cpu[k]
        moved = moved_values(a["histogram"]["counts"],
                             b["histogram"]["counts"])
        worst[f"{k}.moved"] = moved
        require(a["n"] == b["n"] and 0 <= moved <= HIST_MOVES,
                f"quality report {k} counts: {a['histogram']['counts']} "
                f"against {b['histogram']['counts']}")
        for f in ("mean", "std", "min", "max"):
            close(k, a[f], b[f], atol, rtol)
        for p in b["percentiles"]:
            close(k, a["percentiles"][p], b["percentiles"][p], atol, rtol)
        for e1, e2 in zip(a["histogram"]["edges"], b["histogram"]["edges"]):
            close(k, e1, e2, atol, rtol)
    for k in ("d_fooled_fraction", "nn_copy_fraction"):
        require(card[k] == cpu[k], f"quality report {k}")
    for k, v in cpu["diversity"].items():
        close(f"diversity.{k}", card["diversity"][k], v, 0.0,
              QUALITY_DIV_RTOL)
    require(("v_rating" in card) == ("v_rating" in cpu), "V's ratings")
    for k, v in cpu.get("v_rating", {}).items():
        close(f"v_rating.{k}", card["v_rating"][k], v, QUALITY_SCORE_ATOL)
    require(bool(np.isfinite(card["nn_l2"]["mean"])), "NN distances")
    return worst


def quality_on_card(ckpt: str, v_path: str, root: str) -> dict:
    """Phase 39: cli.eval_quality on phase 8's checkpoint, with phase 22's
    V in its --save, at QUALITY_SAMPLES samples against a BENCH_CORPUS-
    image fixture corpus, on the card and on the CPU (the same draws: the
    port draws on the host from the seed): every field of the card's
    report against the CPU's (``reports_agree``), each run's wall time;
    then cli.show_ckpt on the checkpoint, whose output must equal a
    separate CPU process's."""
    import contextlib
    import io

    from catgen_torch.cli import eval_quality as eval_cli
    from catgen_torch.cli import show_ckpt

    save = os.path.join(root, "save")
    os.makedirs(save)
    shutil.copy(v_path, save)
    t0 = time.perf_counter()
    dirs = write_corpus(os.path.join(root, "corpus"), BENCH_CORPUS)
    print(f"{BENCH_CORPUS} fixture images written in "
          f"{time.perf_counter() - t0:.1f} s")
    argv = ["--save", save, "--network", ckpt, "--samples",
            str(QUALITY_SAMPLES), "--dataset", *dirs]
    reports, walls = {}, {}
    for dev in ("cuda", "cpu"):
        reset_counts()
        t0 = time.perf_counter()
        reports[dev] = eval_cli.main(argv + ["--device", dev, "--out",
                                             os.path.join(root,
                                                          f"{dev}.json")])
        walls[dev] = time.perf_counter() - t0
        if dev == "cuda":
            launches = sampler_counts()["fwd"]
            require(launches == 2 * (2 * QUALITY_SAMPLES // 256),
                    f"D's sampler launches in the card's report: {launches}")
        print(f"eval_quality on the {dev}: {walls[dev]:.2f} s wall "
              f"(models rebuilt, corpus decoded, {QUALITY_SAMPLES} samples "
              f"scored, NN against {BENCH_CORPUS})")
    worst = reports_agree(reports["cuda"], reports["cpu"])
    print(f"the card's report equals the CPU's: D scores and V ratings "
          f"within {QUALITY_SCORE_ATOL}, NN distances within {NN_RTOL} and "
          f"diversity within {QUALITY_DIV_RTOL} relative, at most "
          f"{HIST_MOVES} values across a histogram edge; largest "
          f"differences {worst}")
    require("v_rating" in reports["cuda"], "V was not picked up")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        show_ckpt.main([ckpt])
    cpu = subprocess.run(
        [sys.executable, "-m", "catgen_torch.cli.show_ckpt", ckpt],
        capture_output=True, text=True, timeout=120, check=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}).stdout
    print(f"show_ckpt: {len(buf.getvalue().splitlines())} lines, equal to "
          f"the CPU process's: {buf.getvalue() == cpu}; "
          f"{buf.getvalue().splitlines()[-1].strip()}")
    require(buf.getvalue() == cpu, "show_ckpt's output differs")
    return {"wall_s": walls, "max_diff": worst,
            "v_rating": reports["cuda"]["v_rating"],
            "d_fooled_fraction": reports["cuda"]["d_fooled_fraction"]}


def add_16px_entries(by_name: dict, base64: dict, new_err: dict,
                     new_t: dict, s16: dict, st16_err: dict, st16_t: dict,
                     steps16: dict, runs16: dict, zoo: dict) -> None:
    """Adds phases 37-38's readings to the kernels line's entries
    (``by_name``: entry by kernel name): rows 4 and 6 at G64_stack's base
    stages under ``at_64px``; ``at_16px`` (the 16px models' shapes, the
    kinds, errors and times there, and the launches in a 16px step and in
    the 16px CLI runs) and, for the upsample-conv kernels, ``at_g32up``
    (G32up's first stage, and its step's launches)."""
    # rows 4 and 6 at G64_stack's base stages, B=256 (phase 37)
    for dtype, suffix in (("f32", ""), ("bf16", "_bf16")):
        for key, rows in (("block", base64[dtype]["block"]),
                          ("block_dx", base64[dtype]["block_backward"]),
                          ("block_dck", base64[dtype]["block_backward"])):
            name = dict((k, n) for k, n, *_ in UP_KERNELS)[key] + suffix
            by_name[name]["at_64px"]["base_stages"] = {
                "shapes": [str(stage_shape(i, B64)) for i in range(3)],
                "what": LIBRARY_CALL["block_sums" if key == "block"
                                     else "block_backward"], "rows": rows}
    # the 16px models and G32up (phases 37-38): the shapes they give the
    # kernels, the kinds, errors and times there, and their launches in a
    # 16px step (phase 38's card-against-CPU steps: the per-layer kernels
    # on the per-layer route, the block kernels on the ladder) and in the
    # 16px CLI runs; G32up's in its one step on each route
    time_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                 "library_device_ms")
    for dtype, suffix, prefix in (("f32", "", ""), ("bf16", "_bf16", "BF16_")):
        for key, name, counter, _, _ in UP_KERNELS:
            block = key.startswith("block")
            route = "ladder" if block else "per-layer"
            rows = new_t[dtype][key]
            for tag, idx, shapes, err, launches in (
                    ("at_16px", (0, 1), G16UP_STAGES, new_err[dtype]["g16up"],
                     {"launches_16px_step": steps16[f"{dtype}_{route}"][
                         "launches"][f"up_{prefix}{counter}"],
                      "launches_train_16px_ladder": runs16[
                          f"default_{dtype}_ladder"]["launches"][
                          f"up_{prefix}{counter}"]}),
                    ("at_g32up", (2,), G32UP_STAGES, new_err[dtype]["g32up"],
                     {"launches_g32up_f32_step": zoo[
                         f"g32up_d32_st3_{route}"]["launches"][
                         f"up_{counter}"]})):
                by_name[name + suffix][tag] = {
                    "shapes": [str(sh) for sh in shapes], **launches,
                    "kind": ("bf16 forward: " + str(err["kinds"])
                             if dtype == "bf16" else "3xTF32"),
                    "max_abs_err": err[key],
                    "max_rel_err": err[f"{key}_rel"],
                    "max_rel_err_vs_float64": err["vs_float64"].get(key),
                    "bound_by": rows[idx[0]]["bound_by"],
                    **{f"{k}_by_shape": [rows[i][k] for i in idx]
                       for k in time_keys}}
        for key, counter in (("fwd", "LAUNCHES"),
                             ("dcoords", "DCOORDS_LAUNCHES"),
                             ("dimg", "DIMG_LAUNCHES")):
            name = {"fwd": "bilinear_sample_rows",
                    "dcoords": "bilinear_sample_rows_bwd_dcoords",
                    "dimg": "bilinear_sample_rows_bwd_dimg"}[key] + suffix
            rows = [s16[dtype]["rows"][f"{key} {sh}"]
                    for sh in SAMPLER16_SHAPES]
            by_name[name]["at_16px"] = {
                "shapes": [str(sh) for sh in SAMPLER16_SHAPES],
                "kind_by_shape": [r["kind"] for r in rows],
                "max_abs_err": s16[dtype]["max_abs_err"][key],
                "launches_16px_step": steps16[f"{dtype}_default"][
                    "launches"][prefix + counter],
                "launches_train_16px": runs16[f"default_{dtype}_default"][
                    "launches"][prefix + counter],
                "bound_by": rows[0]["bound_by"],
                **{f"{k}_by_shape": [r[k] for r in rows] for k in time_keys}}
        st_name = "st_conv_prelu" + suffix
        st_counter = "st_conv_bf16" if dtype == "bf16" else "st_conv"
        by_name[st_name]["at_16px"] = {
            "shape": str(ST16_SHAPES[0]),
            "max_abs_err": st16_err[dtype]["out"],
            "max_rel_err": st16_err[dtype]["out_rel"],
            "z_max_abs_err": st16_err[dtype]["z"],
            "samp_max_abs_err": st16_err[dtype]["samp"],
            "launches_16px_step": steps16[f"{dtype}_fused-prefix"][
                "launches"][st_counter],
            "launches_train_16px": runs16[f"default_{dtype}_fused_prefix"][
                "launches"][st_counter],
            **st16_t[dtype]["train"],
            "sampling_path": {"shape": str(ST16_SHAPES[1]),
                              **st16_t[dtype]["sample"]}}
    by_name["bilinear_sample_grid"]["at_16px"] = {
        "shape": "V16's warp generator, (16, 16, 3) -> 16x16",
        "launches_v16_run": runs16["v16"]["grid_launches"]}


# ---------------------------------------------------------------------------
# phase 40: data parallelism (catgen_torch/dist) and the native decoder
# ---------------------------------------------------------------------------

DP_ROUTES = (("default", None), ("ladder", LADDER))
DP_TIMING_REPS = 5
# the two-rank configurations: catgen's dryrun_multichip three (the
# default; d_iterations=2 with augmentation, normalized inputs and bf16;
# G64_stack against D64 with the 32px core frozen), per-rank batches
DP_CONFIGS = (
    ("default", "g32up_c", "d32_st3", (32, 32, 3), 64, {}),
    ("d_iters2+augment+normalize+bf16", "g32up_c", "d32_st3", (32, 32, 3),
     64, dict(d_iterations=2, augment=True, normalized_inputs=True,
              bf16=True)),
    ("64px_stack+G_freeze", "g64_stack", "d64", (64, 64, 3), 16,
     dict(g_frozen_children=("00_G32up_c",))),
)
DP_STEPS = 3
DP_CLI_ARGS = ["--device", "cuda", "--fixture", "256", "--epochs", "1",
               "--devices", "1", "--numProcesses", "1", "--processId", "0"]


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def native_decoder(root: str) -> dict:
    """Phase 40(a): the port's native JPEG decoder builds and fills the
    loader's cache where a C++ compiler and jpeglib.h are present, decodes
    the fixture within catgen's mean-abs 4.0 of PIL (tests/test_native.py)
    and refuses a corrupt file."""
    import numpy as np
    from PIL import Image

    from catgen_torch.data import loader, native_decode
    from catgen_torch.data.fixture import write_fixture_dataset

    corpus = os.path.join(root, "corpus")
    write_fixture_dataset(corpus, n=64, size=96, seed=2)
    toolchain = bool(shutil.which(os.environ.get("CXX", "g++"))
                     or shutil.which("c++")) and any(
        os.path.exists(os.path.join(d, "jpeglib.h"))
        for d in ("/usr/include", "/usr/local/include",
                  "/usr/include/x86_64-linux-gnu"))
    t0 = time.perf_counter()
    ds = loader.ImageDataset([corpus], scale=32)
    ds.slice_uint8(0, 1)
    seconds = time.perf_counter() - t0
    print(f"decoder used: {ds.decoder_used}; build error: "
          f"{ds.decoder_error}; C++ compiler and jpeglib.h present: "
          f"{toolchain}; cache of {len(ds)} images filled in "
          f"{seconds:.3f} s")
    if toolchain:
        require(ds.decoder_used == "native", "the native decoder did not "
                "run where a compiler and jpeglib.h are present")
    out = {"decoder_used": ds.decoder_used, "build_error": ds.decoder_error,
           "toolchain": toolchain}
    if ds.decoder_used != "native":
        return out
    diffs = []
    for p in ds.paths[:8]:
        got, ok = native_decode.decode_batch_checked([p], 64)
        require(ok.all(), f"the native decoder failed on {p}")
        ref = np.asarray(Image.open(p).convert("RGB").resize(
            (64, 64), Image.BILINEAR))
        diffs.append(float(np.abs(got[0].astype(int)
                                  - ref.astype(int)).mean()))
    print(f"native vs PIL at 96 -> 64: mean abs {max(diffs):.3f} at most "
          f"(bound 4.0)")
    require(max(diffs) < 4.0, "the native decoder disagrees with PIL")
    bad = os.path.join(root, "bad")
    write_fixture_dataset(bad, n=2, size=64, seed=3)
    with open(os.path.join(bad, "zz_corrupt.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff not a jpeg")
    try:
        loader.ImageDataset([bad], scale=32).slice_uint8(0, 1)
    except ValueError as e:
        require("failed to decode" in str(e), f"wrong refusal: {e}")
        print(f"corrupt file refused: {str(e)[:80]}...")
    else:
        raise RuntimeError("the loader took a corrupt file")
    out["pil_mean_abs_max"] = max(diffs)
    return out


def dp_pair(g_name: str, d_name: str, image, axis, seed: int = 3):
    """(G, D) of the registry built with ``axis`` and holding seeded
    weights (``seeded_pair``'s for the flagship, else ``perturb``'s)."""
    from catgen_torch import models

    if (g_name, d_name) == ("g32up_c", "d32_st3"):
        src = seeded_pair(seed, G_GAIN, D_GAIN)
    else:
        src = (models.G_REGISTRY[g_name](image, 100),
               models.D_REGISTRY[d_name](image))
        perturb(*src, seed, G_GAIN, D_GAIN)
    g = models.G_REGISTRY[g_name](image, 100, axis_name=axis)
    d = models.D_REGISTRY[d_name](image, axis_name=axis)
    g.load_state_dict(src[0].state_dict())
    d.load_state_dict(src[1].state_dict())
    return g, d


def dp_launches(route, bf16: bool) -> tuple:
    """(launches since the last reset, one step's design): phase 5's and
    15's (``expected_sampler``, ``expected_upsample``) in f32, phase 32's
    (``expected_bf16_route``) in bf16."""
    got = bf16_route_counts()
    if bf16:
        return got, expected_bf16_route(route, 1, 0, 0)
    up, d = expected_upsample(route, 1, 0), expected_sampler(route, 1, 0)
    want = dict.fromkeys(got, 0)
    want.update({f"up_{k}": v for k, v in up.items()})
    want.update(LAUNCHES=d["fwd"], DCOORDS_LAUNCHES=d["dcoords"],
                DIMG_LAUNCHES=d["dimg"], st_conv=d["st_conv"])
    return got, want


def dp_world_of_one(card_name: str) -> dict:
    """Phase 40(b) and (e): in a world of one NCCL rank on cuda:0 the DP
    GAN step (G32up-c against D32_st3, batch 640, augmented) on the
    default and ladder routes, f32 and bf16, equals the plain step bit for
    bit (every parameter, buffer, optimizer tensor and metric) and
    launches what the plain step launches, plus its all-reduces; then the
    DP step's time beside the plain step's on the default route."""
    import torch
    from catgen_torch.core.random import Draws
    from catgen_torch.dist import dp, mesh
    from catgen_torch.kernels import config as upconfig
    from catgen_torch.train import gan

    out = {}
    # the CLIs' mode: cuDNN's deterministic algorithms, so that two runs
    # of one step can agree bit for bit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    reals = torch.rand((TRAIN_B // 2, 32, 32, 3),
                       generator=torch.Generator().manual_seed(4)).cuda()
    cuda0 = torch.device("cuda", 0)
    with mesh.session(f"localhost:{free_port()}", device=cuda0,
                      backend="nccl"):
        for bf16 in (False, True):
            dtype = torch.bfloat16 if bf16 else torch.float32
            config = gan.GanConfig(batch_size=TRAIN_B, augment=True,
                                   compute_dtype=dtype)
            for name, route in DP_ROUTES:
                key = f"{name}_{'bf16' if bf16 else 'f32'}"
                runs = {}
                for is_dp in (False, True):
                    g, d = dp_pair("g32up_c", "d32_st3", (32, 32, 3),
                                   mesh.DATA_AXIS if is_dp else None)
                    state = gan.init_state(g.cuda(), d.cuda(), config)
                    step = (dp.make_dp_train_step(g, d, config) if is_dp
                            else gan.make_train_step(g, d, config))
                    draws = Draws(mesh.rank_generator(5, "cuda"))
                    reset_counts()
                    mesh.reset_counts()
                    with upconfig.using(**(route or {})):
                        m = step(state, reals, draws)
                    torch.cuda.synchronize()
                    got, want = dp_launches(route, bf16)
                    require(got == want, f"{key} {'DP' if is_dp else 'plain'}"
                            f" step's launches {got}, expected {want}")
                    runs[is_dp] = (mesh.state_tensors(state), m, got,
                                   mesh.ALL_REDUCES)
                    if is_dp:
                        reduces = dp.all_reduces_per_gan_step(g, d, config)
                    del g, d, state
                (plain, mp, _, _), (dps, md, launches, n) = runs[False], \
                    runs[True]
                differ = [k for k in plain if not torch.equal(plain[k],
                                                              dps[k])]
                require(not differ, f"{key}: the DP step differs from the "
                                    f"plain step at {differ[:4]}")
                for f in mp._fields:
                    require(torch.equal(getattr(mp, f), getattr(md, f)),
                            f"{key}: metric {f} differs")
                require(n == reduces, f"{key}: {n} all-reduces, expected "
                                      f"{reduces}")
                print(f"world of one, {key}: the DP step equals the plain "
                      f"step bit for bit ({len(plain)} state tensors, every "
                      f"metric); launches {({k: v for k, v in launches.items() if v})}"
                      f" as the plain step's, plus {n} all-reduces")
                out[key] = {"bit_equal": True, "all_reduces": n,
                            "launches": launches}
        # (e): what the reductions cost in a world of one
        for bf16 in (False, True):
            dtype = torch.bfloat16 if bf16 else torch.float32
            config = gan.GanConfig(batch_size=TRAIN_B, augment=True,
                                   compute_dtype=dtype)
            steps = {}
            for is_dp in (False, True):
                g, d = dp_pair("g32up_c", "d32_st3", (32, 32, 3),
                               mesh.DATA_AXIS if is_dp else None)
                state = gan.init_state(g.cuda(), d.cuda(), config)
                fn = (dp.make_dp_train_step(g, d, config) if is_dp
                      else gan.make_train_step(g, d, config))
                draws = Draws(mesh.rank_generator(6, "cuda"))
                steps[is_dp] = (lambda fn=fn, state=state, draws=draws:
                                fn(state, reals, draws))
            walls = {False: [], True: []}
            for _ in range(2):                        # warm-up
                for is_dp in (False, True):
                    steps[is_dp]()
            torch.cuda.synchronize()
            for i in range(DP_TIMING_REPS):   # plain, DP, DP, plain, ...
                for is_dp in ((False, True) if i % 2 == 0 else
                              (True, False)):
                    t0 = time.perf_counter()
                    steps[is_dp]()
                    torch.cuda.synchronize()
                    walls[is_dp].append((time.perf_counter() - t0) * 1e3)
            key = "bf16" if bf16 else "f32"
            plain_ms = statistics.median(walls[False])
            dp_ms = statistics.median(walls[True])
            print(f"world of one, default route, {key}, batch {TRAIN_B}: "
                  f"plain step {plain_ms:.3f} ms, DP step {dp_ms:.3f} ms "
                  f"(median of {DP_TIMING_REPS}, in turns; the reductions "
                  f"cost {dp_ms - plain_ms:+.3f} ms); {card_name}")
            out[f"time_{key}"] = {"plain_ms": plain_ms, "dp_ms": dp_ms,
                                  "plain_walls": walls[False],
                                  "dp_walls": walls[True]}
            del steps
    return out


def dp_rank_main(local_rank: int, device, spec: dict) -> dict:
    """Phase 40(c), one of two gloo ranks on one card: catgen's three
    configurations, DP_STEPS steps each with the state bit-equal across
    the ranks after them (and frozen children bit-equal to their start);
    then one f32 DP step at 2 x 320 on the single step's weights and
    draws, split by rank."""
    import numpy as np
    import torch
    from catgen_torch.cli.common import resolve_device
    from catgen_torch.core.random import Draws
    from catgen_torch.dist import dp, mesh
    from catgen_torch.dist.parity import ReplayDraws, split_draws
    from catgen_torch.train import gan

    # a fresh process: the CLIs' numeric mode (a new process would run
    # cuDNN's convolutions in TF32, torch's default)
    resolve_device(str(device))
    rank, world = mesh.rank(), mesh.world_size()
    out = {}
    for label, g_name, d_name, image, batch, kw in DP_CONFIGS:
        kw = dict(kw)
        dtype = torch.bfloat16 if kw.pop("bf16", False) else torch.float32
        config = gan.GanConfig(batch_size=batch, compute_dtype=dtype, **kw)
        g, d = dp_pair(g_name, d_name, image, mesh.DATA_AXIS)
        state = gan.init_state(g.to(device), d.to(device), config)
        mesh.replicate(state)
        frozen = {k: v.clone() for k, v in g.state_dict().items()
                  if k.startswith(tuple(f"{c}." for c in
                                        config.g_frozen_children))}
        step = dp.make_dp_train_step(g, d, config)
        rs = np.random.RandomState(rank)
        for i in range(DP_STEPS):
            reals = torch.from_numpy(rs.rand(
                config.d_iterations * batch // 2, *image).astype(
                    np.float32)).to(device)
            if config.normalized_inputs:
                reals = reals * 2.0 - 1.0
            m = step(state, reals, Draws(mesh.rank_generator(i, device)))
        torch.cuda.synchronize()
        nbytes = mesh.assert_replicated(state)
        now = g.state_dict()
        require(all(torch.equal(v, now[k]) for k, v in frozen.items()),
                f"{label}: a frozen G child moved")
        require(bool(torch.isfinite(m.loss_d)) and bool(
            torch.isfinite(m.loss_g)), f"{label}: non-finite losses")
        out[label] = {"replicated_bytes": nbytes, "frozen": len(frozen),
                      "loss_d": float(m.loss_d), "loss_g": float(m.loss_g),
                      "step": state.step}
        del g, d, state, step
    s = spec["split"]
    g, d = dp_pair("g32up_c", "d32_st3", (32, 32, 3), mesh.DATA_AXIS)
    g.load_state_dict(s["g"])
    d.load_state_dict(s["d"])
    config = gan.GanConfig(batch_size=TRAIN_B // world, augment=True,
                           d_optimizer="sgd")
    state = gan.init_state(g.to(device), d.to(device), config)
    grads = []
    step = dp.make_dp_train_step(g, d, config)
    real_cap = gan.optim.clamp_and_penalize

    def spy(gr, *a, **k):
        grads.append({n: t.detach().cpu() for n, t in gr.items()})
        return real_cap(gr, *a, **k)

    gan.optim.clamp_and_penalize = spy
    try:
        n = TRAIN_B // 2 // world
        m = step(state, s["reals"][rank * n:(rank + 1) * n].to(device),
                 ReplayDraws(split_draws(s["records"], rank, world,
                                         s["pairs"]), device))
    finally:
        gan.optim.clamp_and_penalize = real_cap
    mesh.assert_replicated(state)
    out["split"] = {"metrics": {k: v.item() for k, v in m._asdict().items()},
                    "grads": grads if rank == 0 else None}
    return out


def pool_fed(model) -> set:
    """The weight and bias names of every layer of ``model`` whose output
    reaches a max pool directly or through one activation."""
    from catgen_torch.nn.layers import MaxPool

    out = set()
    for prefix, seq in model.named_modules():
        kids = list(seq.named_children())
        for i, (name, layer) in enumerate(kids):
            nxt = [m for _, m in kids[i + 1:i + 3]]
            if hasattr(layer, "weight") and nxt and (
                    isinstance(nxt[0], MaxPool) or (
                        len(nxt) == 2 and isinstance(nxt[1], MaxPool)
                        and not hasattr(nxt[0], "weight"))):
                base = f"{prefix}.{name}" if prefix else name
                out |= {f"{base}.weight", f"{base}.bias"}
    return out


def dp_two_ranks() -> dict:
    """Phase 40(c): two gloo ranks on cuda:0 (``dp_rank_main``), and the
    single-process f32 step at batch 640 that their 2 x 320 step must
    match within phase 9's bounds: losses within STEP_LOSS_RTOL, gradients
    within GRAD_REL of each leaf's largest (+ GRAD_FLOOR of the update's
    largest). The two steps split the batch differently and so round
    differently; where an activation sits within rounding of a switch,
    one of them takes the other side and that element's gradient moves by
    a part of itself (tests/test_torch_port_dist.py; at 640 images there
    are hundreds of such elements a step: with catgen's slopes the worst
    leaves came 1.1-1.5 times the bound, with TF32 left on in the ranks
    60). So, for this comparison only, the switches are taken away where
    the weights allow: every PReLU's slope is 1 (G and D smooth but for
    D's max pool), D's ST heads have zero weights and seeded biases (the
    grids are not the identity but come from no batched product, so both
    steps sample at the same coordinates, and no coordinate crosses a
    pixel edge), and D updates by SGD (Adam's first step would turn a D
    gradient within rounding of zero into +-lr, and the G phase would
    differentiate through two different Ds). A max pool's choice between
    two values within rounding remains: one flip moves a gradient element
    to its neighbour, which at 640 images changes the weight gradient of
    the conv feeding the pool by ~1/sqrt(its 163840 terms) ~ 2.5e-3 of the
    leaf; D's leaves that feed a max pool (``pool_fed``) are held to
    G64_GRAD_REL, phase 36's bound for the same kind of flip (on an H100:
    the conv branch's 1.5e-3, every other leaf within phase 9's)."""
    import torch
    from catgen_torch.core.random import Draws
    from catgen_torch.dist import launch
    from catgen_torch.dist.parity import RecordingDraws, gan_pairs
    from catgen_torch.train import gan

    world = 2
    g, d = dp_pair("g32up_c", "d32_st3", (32, 32, 3), None)
    with torch.no_grad():     # no switch within rounding (see above)
        for name, p in list(g.named_parameters()) + list(
                d.named_parameters()):
            if ".head" in name and name.endswith("weight"):
                p.zero_()
            elif name.endswith(".alpha"):
                p.fill_(1.0)
    split = {"g": {k: v.clone() for k, v in g.state_dict().items()},
             "d": {k: v.clone() for k, v in d.state_dict().items()},
             "reals": torch.rand((TRAIN_B // 2, 32, 32, 3),
                                 generator=torch.Generator().manual_seed(8))}
    config = gan.GanConfig(batch_size=TRAIN_B, augment=True,
                           d_optimizer="sgd")
    state = gan.init_state(g.cuda(), d.cuda(), config)
    draws = RecordingDraws(Draws(torch.Generator("cuda").manual_seed(9)))
    grads = []
    real_cap = gan.optim.clamp_and_penalize

    def spy(gr, *a, **k):
        grads.append({n: t.detach().cpu() for n, t in gr.items()})
        return real_cap(gr, *a, **k)

    mode = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    gan.optim.clamp_and_penalize = spy
    try:
        m = gan.make_train_step(g, d, config)(state, split["reals"].cuda(),
                                              draws)
    finally:
        gan.optim.clamp_and_penalize = real_cap
        torch.backends.cudnn.deterministic = mode
    split["records"] = [(k, t.cpu()) for k, t in draws.records]
    split["pairs"] = gan_pairs(draws.records, TRAIN_B // 2 // world, world,
                               100)
    del g, state
    t0 = time.perf_counter()
    ranks = launch.launch(dp_rank_main, world, args=({"split": split},),
                          devices=["cuda:0"] * world, backend="gloo",
                          timeout_s=300.0)
    print(f"two gloo ranks on cuda:0: {time.perf_counter() - t0:.1f} s "
          f"(both processes' start included)")
    for label, *_ in DP_CONFIGS:
        require(ranks[0][label] == ranks[1][label],
                f"{label}: the ranks' results differ")
        print(f"two ranks, {label}: {DP_STEPS} steps, state bit-equal "
              f"across the ranks ({ranks[0][label]['replicated_bytes']} "
              f"bytes), {ranks[0][label]['frozen']} frozen tensors held, "
              f"loss_d {ranks[0][label]['loss_d']:.6f}")
    got = ranks[0]["split"]
    for r in ranks:
        for name in ("loss_d", "loss_g", "acc_d", "acc_avg"):
            a, b = r["split"]["metrics"][name], float(getattr(m, name))
            require(abs(a - b) <= STEP_LOSS_RTOL * abs(b),
                    f"2 x 320 {name} {a} vs the 640 step's {b}")
        for name in ("d_trained", "tp_real", "tn_fake", "fp", "fn"):
            require(r["split"]["metrics"][name] == float(getattr(m, name)),
                    f"2 x 320 {name} differs")
    pooled = pool_fed(d)
    worst, over = {}, []
    for phase_name, a, b in zip("DG", got["grads"], grads):
        top = max(v.abs().max().item() for v in b.values())
        ratios = []
        for k in b:
            err = (a[k] - b[k]).abs().max().item()
            rel = G64_GRAD_REL if phase_name == "D" and k in pooled \
                else GRAD_REL
            bound = rel * b[k].abs().max().item() + GRAD_FLOOR * top
            ratios.append((err / bound, k, err, b[k].abs().max().item()))
            if err > bound:
                over.append(f"{phase_name} {k}: {err:.3e} > {bound:.3e}")
        ratios.sort(reverse=True)
        print(f"2 x 320 against 640, {phase_name} phase gradients, worst "
              f"leaves (error over the bound; error; leaf's largest; the "
              f"update's largest {top:.3e}): " + "; ".join(
                  f"{k} {r:.3f} {e:.2e} {m:.2e}" for r, k, e, m in
                  ratios[:6]))
        worst[phase_name] = ratios[0][0]
    require(not over, f"2 x 320 gradients beyond phase 9's bounds: {over}")
    print(f"DP 2 x 320 against the single step at {TRAIN_B}: losses within "
          f"{STEP_LOSS_RTOL}, worst gradient leaf D {worst['D']:.3f}, G "
          f"{worst['G']:.3f} of its bound ({GRAD_REL} of the leaf's "
          f"largest + {GRAD_FLOOR} of the update's)")
    return {"configs": {label: ranks[0][label]
                        for label, *_ in DP_CONFIGS},
            "split_metrics": got["metrics"],
            "split_worst_over_bound": worst}


def dp_clis(root: str) -> dict:
    """Phase 40(d): cli.train, cli.train_v and cli.pretrain_g on the card
    through the multi-host flags as a world of one (one epoch each); and
    --devices 2 refused on a one-card machine."""
    import torch
    from catgen_torch.cli import pretrain_g as pretrain_cli
    from catgen_torch.cli import train as train_cli
    from catgen_torch.cli import train_v as train_v_cli
    from catgen_torch.train import harness as tharness

    out = {}
    for name, cli, extra, ckpt in (
            ("train", train_cli, ["--batchSize", "64", "--N_epoch", "320",
                                  "--augment"], "adversarial.ckpt"),
            ("train_v", train_v_cli, ["--batchSize", "32", "--N_epoch",
                                      "320"], "v_3x32x32.ckpt"),
            ("pretrain_g", pretrain_cli, ["--batchSize", "16", "--N_epoch",
                                          "160"],
             "g_pretrained_3x32x32_nd100.ckpt")):
        save = os.path.join(root, name)
        bank, tharness.OVERLAY_BANK = tharness.OVERLAY_BANK, V16_BANK
        t0 = time.perf_counter()
        try:
            h = cli.main(DP_CLI_ARGS + ["--coordinator",
                                        f"localhost:{free_port()}",
                                        "--save", save] + extra)
        finally:
            tharness.OVERLAY_BANK = bank
        seconds = time.perf_counter() - t0
        require(h.dp and h.hc.n_devices == 1 and h.state.epoch == 2,
                f"cli.{name}: not a world of one's run")
        require(not torch.distributed.is_initialized(),
                f"cli.{name} left its process group")
        require(os.path.exists(os.path.join(save, ckpt)),
                f"cli.{name} wrote no {ckpt}")
        print(f"cli.{name} --devices 1 --coordinator ... --numProcesses 1 "
              f"--processId 0: one epoch in {seconds:.1f} s, {ckpt} written")
        out[name] = seconds
    cards = torch.cuda.device_count()
    try:
        train_cli.main(["--device", "cuda", "--devices", str(cards + 1),
                        "--save", os.path.join(root, "refused")])
    except SystemExit as e:
        require("card" in str(e), f"wrong refusal: {e}")
        print(f"--devices {cards + 1} on {cards} card(s) refused: {e}")
    else:
        raise RuntimeError("more ranks than cards were not refused")
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
        sample_counts, sample_result = slice_on_card(save)
        phase(6, "the sampling slice at count 64, card against CPU")
        card_vs_cpu(save)
        phase(7, "sampling times on the card")
        t = times(save, card_name)
    # phase 8's checkpoint, kept for the 64px warm start (phase 35)
    run32 = tempfile.TemporaryDirectory(prefix="chip_smoke_run32_")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as save:
        phase(8, "the training slice through the CLI")
        train_counts, _, steps = train_on_card(save)
        shutil.copy(os.path.join(save, "adversarial.ckpt"), run32.name)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_repeat_") as root:
        phase(8, "the training CLI twice from one seed: its numeric mode, "
                 "the same checkpoint bits")
        cli_repeats(root)
    phase(9, "one train step, card against CPU")
    step_card_vs_cpu()
    phase(10, f"training times on the card, batch {TRAIN_B}")
    tt = train_times(card_name)
    phase(11, "the upsample-conv kernels against their plain versions")
    up_err = upsample_vs_plain()
    exact = {**fwd_vs_float64(), **dck_vs_float64(), **dx_vs_float64()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ladder_") as save:
        write_checkpoint(save)      # the same seeded weights as phase 5
        phase(12, f"the sampling slice on the ladder route, {COUNT} "
                  f"samples")
        _, ladder_sample = slice_on_route(save, "ladder", LADDER,
                                          sample_result)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ladder_") as save:
        phase(13, "the training slice through the CLI on the ladder route")
        _, ladder_train, _ = train_on_card(save, LADDER)
    phase(14, "one train step on the per-layer route")
    per_layer = per_layer_steps()
    phase(15, "one train step on the ladder route, card against CPU")
    step_card_vs_cpu(LADDER)
    phase(16, f"upsample-conv times on the card, batch {TRAIN_B}")
    ut = upsample_times(card_name)
    rt = {name: route_train_times(card_name, name, route)
          for name, route in (("ladder", LADDER),
                              ("per-layer", PER_LAYER))}
    print(f"train step, batch {TRAIN_B}: default route "
          f"{tt['step_ms']:.3f} ms, ladder route {rt['ladder']['step_ms']:.3f}"
          f" ms, per-layer route {rt['per-layer']['step_ms']:.3f} ms (same "
          f"run); {card_name}")
    phase(17, "the ST-conv kernel against its plain version")
    st_err = st_conv_vs_plain()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_d_") as save:
        write_checkpoint(save)      # the same seeded weights as phase 5
        phase(18, f"D's fused-prefix route: the sampling slice, {COUNT} "
                  f"samples")
        fused_sample, _ = slice_on_route(save, "fused-prefix", FUSED,
                                         sample_result)
        phase(19, f"the grid-sampler kernels against their plain versions; "
                  f"the v1 grid route: the sampling slice, {COUNT} samples")
        grid_err = grid_vs_plain()
        grid_sample, _ = slice_on_route(save, "grid-v1", GRID["v1"],
                                        sample_result)
    del sample_result
    with tempfile.TemporaryDirectory(prefix="chip_smoke_d_") as save:
        phase(18, "D's fused-prefix route: the training slice through the "
                  "CLI, one epoch")
        fused_train, _, _ = train_on_card(save, FUSED, n_epochs=1)
    phase(18, "one train step on the fused-prefix route, card against CPU")
    fused_step = step_card_vs_cpu(FUSED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_d_") as save:
        phase(19, "the v1 grid route: the training slice through the CLI, "
                  "one epoch")
        grid_train, _, _ = train_on_card(save, GRID["v1"], n_epochs=1)
    phase(19, "one train step on the v2 and v3 grid routes")
    gen_steps = generation_steps()
    phase(20, f"D's kernel times on the card, batch {TRAIN_B}")
    st_t = st_conv_times(card_name)
    gt = grid_times(card_name)
    rd = {name: route_train_times(card_name, name, route)
          for name, route in (("default", {}), ("fused-prefix", FUSED),
                              ("grid-v1", GRID["v1"]))}
    print(f"train step, batch {TRAIN_B}: default route "
          f"{rd['default']['step_ms']:.3f} ms, fused-prefix route "
          f"{rd['fused-prefix']['step_ms']:.3f} ms, v1 grid route "
          f"{rd['grid-v1']['step_ms']:.3f} ms (same run, in that order); "
          f"{card_name}")

    phase(21, "the grid forward kernel at the V warp generator's shape")
    warp_err = warp_vs_plain()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_workflow_") as save:
        phase(22, "the V trainer through cli.train_v, batch 32, 2 epochs")
        t0 = time.perf_counter()
        v_harness, v_counts = v_cli_on_card(save)
        shutil.copy(os.path.join(save, "v_3x32x32.ckpt"), run32.name)
        v_step = v_step_card_vs_cpu(v_harness.bank)
        print(f"phase 22: {time.perf_counter() - t0:.1f} s")
        phase(23, "the G pretrainer through cli.pretrain_g, default and "
                  "ladder routes")
        t0 = time.perf_counter()
        pretrain_cli_on_card(save)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_pre_") as other:
            pre_ladder = pretrain_cli_on_card(other, LADDER)
        pre_step = ladder_pretrain_card_vs_cpu()
        print(f"phase 23: {time.perf_counter() - t0:.1f} s")
        phase(24, "the workflow: cli.train picks up V and the pretrained "
                  "G, cli.sample reads its checkpoint")
        t0 = time.perf_counter()
        ratings = workflow_on_card(save)
        print(f"phase 24: {time.perf_counter() - t0:.1f} s")
        phase(25, f"V and pretrain times on the card, batch {TRAIN_B}")
        t0 = time.perf_counter()
        vt = v_times(card_name, v_harness.bank)
        pt = {name: pretrain_times(card_name, route)
              for name, route in (("default", None), ("ladder", LADDER))}
        print(f"phase 25: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"v_and_pretrain": {
        "bank_seconds": v_harness.bank_seconds, "warp_max_abs_err": warp_err,
        "v_step_card_vs_cpu": v_step, "pretrain_ladder_card_vs_cpu":
        pre_step, "v_ratings": ratings, "v_times_ms": vt,
        "pretrain_times_ms": pt, "card": card_name}}))
    del v_harness

    phase(26, "the bf16 sampler kernels against their bf16 plain versions")
    t0 = time.perf_counter()
    bf16_err = bf16_vs_plain()
    print(f"phase 26: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as root:
        phase(27, "the training CLI in bf16 (--dtype bf16), twice from one "
                  "seed; one bf16 step on the v1 grid route")
        t0 = time.perf_counter()
        bf16_train, bf16_steps, bf16_grid = bf16_train_on_card(root)
        print(f"phase 27: {time.perf_counter() - t0:.1f} s")
    phase(28, "one bf16 step and one bf16 remat step, card against CPU")
    t0 = time.perf_counter()
    bf16_step = bf16_step_card_vs_cpu()
    print(f"phase 28: {time.perf_counter() - t0:.1f} s")
    phase(29, f"bf16 and f32 times and memory on the card, batch {TRAIN_B}")
    t0 = time.perf_counter()
    bt = bf16_times(card_name, vt[f"batch_{TRAIN_B}"]["generation"])
    print(f"phase 29: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"bf16": {
        "step_card_vs_cpu": bf16_step, "card": card_name,
        **{k: bt[k] for k in ("f32", "bf16", "f32_remat", "bf16_remat",
                              "v_f32", "v_bf16")}}}))

    phase(30, "the bf16 upsample-conv kernels against their bf16 plain "
              "versions and float64 at G32up-c's stage shapes, batch 640")
    t0 = time.perf_counter()
    bf16_up_err = upsample_vs_plain(bf16=True)
    fwd16_kinds = bf16_forward_kinds()
    pass_err = passes_vs_plain()
    exact16 = dck_vs_float64(bf16=True)
    print(f"phase 30: {time.perf_counter() - t0:.1f} s")
    phase(31, "the bf16 ST-conv kernel against its bf16 plain version")
    t0 = time.perf_counter()
    bf16_st_err = st_conv_vs_plain(bf16=True)
    print(f"phase 31: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_routes_") as root:
        phase(32, "the training CLI in bf16 on the ladder and fused-prefix "
                  "routes, twice from one seed; one bf16 step on each "
                  "kernel route, card against CPU")
        t0 = time.perf_counter()
        bf16_cli = bf16_routes_cli(root)
    bf16_route_steps = {name: bf16_route_step_card_vs_cpu(name, route)
                        for name, route in BF16_ROUTES}
    print(f"phase 32: {time.perf_counter() - t0:.1f} s")
    phase(33, f"bf16 kernel and kernel-route step times on the card, batch "
              f"{TRAIN_B}")
    t0 = time.perf_counter()
    bkt = upsample_times(card_name, bf16=True)
    st16 = st_conv_times(card_name, bf16=True)
    brt = bf16_route_step_times(card_name)
    print(f"phase 33: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"bf16_kernel_routes": {
        "card": card_name,
        "steps_card_vs_cpu": {k: {m: v[m] for m in v if m != "launches"}
                              for k, v in bf16_route_steps.items()},
        "steps": {k: {m: v[m] for m in v if m != "kernel_device_ms"}
                  for k, v in brt.items()}}}))

    phase(34, f"the 64px kernels against their plain versions: the refine "
              f"trunk's upsample-conv at {REFINE_SHAPE}, the sampler "
              f"forward at {SAMPLER64_SHAPE}")
    t0 = time.perf_counter()
    refine_err = {"f32": refine_vs_plain(), "bf16": refine_vs_plain(True)}
    refine_t = {"f32": refine_times(card_name),
                "bf16": refine_times(card_name, True)}
    s64 = sampler64(card_name)
    print(f"phase 34: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_64_") as root:
        phase(35, "the 64px run through cli.train (G64_stack against D64, "
                  "--augment --collapseDetect --weightsVisFreq 1 "
                  "--profile), warm-started by cli.stack64_warmstart from "
                  "phase 8's checkpoint; default and kernel routes, f32 "
                  "and bf16")
        t0 = time.perf_counter()
        runs64 = {}
        for bf16 in (False, True):
            for rname, route in (("default", None), ("kernel", ROUTE64)):
                save = os.path.join(root, f"{rname}{int(bf16)}")
                if rname == "default" and not bf16:
                    warmstart64(os.path.join(run32.name, "adversarial.ckpt"),
                                save)
                runs64[f"{'bf16' if bf16 else 'f32'}_{rname}"] = \
                    train64_on_card(save, route, bf16)
        picked = [e for e in runs64["f32_default"].pop("events")
                  if e["event"] == "pretrained_g_loaded"]
        print(f"the 64px run picked up the warm start: {picked}")
        require(len(picked) == 1, "the 64px run did not pick up the warm "
                                  "start")
        for r in runs64.values():
            r.pop("events", None)
        print(f"phase 35: {time.perf_counter() - t0:.1f} s")
    phase(36, f"one 64px step at batch 8, card against CPU; the 64px step "
              f"at batch {B64} in f32 and bf16 on the default and kernel "
              f"routes")
    t0 = time.perf_counter()
    steps64 = steps64_card_vs_cpu()
    t64 = step64_times(card_name)
    print(f"phase 36: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"pyramid_64px": {
        "card": card_name,
        "steps_card_vs_cpu": {k: {m: v[m] for m in v if m != "launches"}
                              for k, v in steps64.items()},
        "cli_runs": runs64,
        "steps": {k: {m: v[m] for m in v if m != "kernel_device_ms"}
                  for k, v in t64.items()}}}))

    phase(37, f"the new kernel shapes against their plain versions, f32 "
              f"and bf16: G16up's and G32up's upsample-convs {NEW_STAGES}, "
              f"the sampler at {SAMPLER16_SHAPES}, the ST-conv at "
              f"{ST16_SHAPES}; rows 4 and 6 at G64_stack's base stages, "
              f"B={B64}")
    t0 = time.perf_counter()
    new_err = {dt: {"g16up": new_stages_vs_plain(dt == "bf16", G16UP_STAGES),
                    "g32up": new_stages_vs_plain(dt == "bf16", G32UP_STAGES)}
               for dt in ("f32", "bf16")}
    new_t = {dt: upsample_times(card_name, dt == "bf16", NEW_STAGES,
                                library_device=False)
             for dt in ("f32", "bf16")}
    st16_err = {dt: st_conv_vs_plain(dt == "bf16", ST16_SHAPES)
                for dt in ("f32", "bf16")}
    st16_t = {dt: st_conv_times(card_name, dt == "bf16",
                                ((ST16_SHAPES[0], True),
                                 (ST16_SHAPES[1], False)), banded=False)
              for dt in ("f32", "bf16")}
    s16 = sampler16(card_name)
    base64 = {dt: base64_block_rows(card_name, dt == "bf16")
              for dt in ("f32", "bf16")}
    print(f"phase 37: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_16_") as root:
        phase(38, "the 16px workflow through the CLIs (train_v and "
                  "pretrain_g --scale 16; train --scale 16 --augment, G16up "
                  "against D32_st3 and D16_st3, default, ladder and "
                  "fused-prefix routes, f32 and bf16; sample); a 16px step "
                  "card against CPU on every route; a step of every other "
                  "new registry key; the 16px step at batch 640")
        t0 = time.perf_counter()
        runs16 = workflow16_on_card(root)
    steps16 = steps16_card_vs_cpu()
    zoo = zoo_steps_on_card()
    t16 = step16_times(card_name)
    print(f"phase 38: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"workflow_16px": {
        "card": card_name, "cli_runs": runs16,
        "steps_card_vs_cpu": {k: {m: v[m] for m in v if m != "launches"}
                              for k, v in steps16.items()},
        "zoo_steps": {k: {m: v[m] for m in v if m != "launches"}
                      for k, v in zoo.items()},
        "steps": {k: {m: v[m] for m in v if m != "kernel_device_ms"}
                  for k, v in t16.items()}}}))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quality_") as root:
        phase(39, f"cli.eval_quality on phase 8's checkpoint with phase "
                  f"22's V, {QUALITY_SAMPLES} samples against a "
                  f"{BENCH_CORPUS}-image corpus, card against CPU; "
                  f"cli.show_ckpt")
        t0 = time.perf_counter()
        quality = quality_on_card(
            os.path.join(run32.name, "adversarial.ckpt"),
            os.path.join(run32.name, "v_3x32x32.ckpt"), root)
        print(f"phase 39: {time.perf_counter() - t0:.1f} s")
    run32.cleanup()
    print(json.dumps({"quality": {"card": card_name, **quality}}))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as root:
        phase(40, "data parallelism: (a) the native decoder; (b) a world of "
                  "one NCCL rank, the DP GAN step at batch 640 bit for bit "
                  "against the plain step, default and ladder routes, f32 "
                  "and bf16; (c) two gloo ranks on the card: catgen's three "
                  "configurations replicated bit for bit, DP 2 x 320 "
                  "against the single step at 640; (d) the three training "
                  "CLIs through the multi-host flags, --devices 2 refused; "
                  "(e) the reductions' cost in a world of one")
        t0 = time.perf_counter()
        decoder = native_decoder(os.path.join(root, "decoder"))
        world1 = dp_world_of_one(card_name)
        two = dp_two_ranks()
        clis = dp_clis(os.path.join(root, "cli"))
        print(f"phase 40: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"data_parallel": {
        "card": card_name, "decoder": decoder, "clis_seconds": clis,
        "world_of_one": {k: {m: v[m] for m in v if m != "launches"}
                         for k, v in world1.items()},
        "two_ranks": two}}))

    from catgen_torch.kernels import bilinear

    def by_shape(values, shapes=TRAIN_SHAPES):
        return dict(zip(map(str, shapes), values))

    source_fwd = "catgen_torch/csrc/bilinear_sample.cu"
    source_bwd = "catgen_torch/csrc/bilinear_sample_bwd.cu"
    kernels = []
    for i, (name, source, err) in enumerate((
            ("bilinear_sample_rows", source_fwd, max_err),
            ("bilinear_sample_rows_bwd_dcoords", source_bwd,
             bwd_err["dcoords"]),
            ("bilinear_sample_rows_bwd_dimg", source_bwd, bwd_err["dimg"]))):
        key = ("fwd", "dcoords", "dimg")[i]
        bounds = [sampler_bound(key, shape) for shape in TRAIN_SHAPES]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": ("catgen/kernels/pallas_bilinear_v4.py:799" if i == 0
                         else "catgen/kernels/pallas_bilinear_v4.py:917"),
            "launches": train_counts[key],
            "launches_by_path": {"sample": sample_counts[i],
                                 "train": train_counts[key],
                                 "sample_fused_prefix": fused_sample[key],
                                 "train_fused_prefix": fused_train[key]},
            "max_abs_err": err,
            "ms": sum(tt[key]), "plain_ms": sum(tt[f"{key}_plain"]),
            "bound_ms": sum(b for b, _ in bounds), "bound_by": "bytes",
            "library_ms": sum(tt[f"{key}_library"]),
            "ms_by_shape": by_shape(tt[key]),
            "plain_ms_by_shape": by_shape(tt[f"{key}_plain"]),
            "library_ms_by_shape": by_shape(tt[f"{key}_library"]),
            "bound_ms_by_shape": by_shape([b for b, _ in bounds]),
        })
    kernels[0]["sampling_ms_by_shape"] = dict(zip(map(str, SAMPLER_SHAPES),
                                                  t["kernel_ms"]))
    for i, key in enumerate(("fwd", "dcoords", "dimg")):
        kernels[i]["device_ms_by_shape"] = by_shape(
            [k for k, _ in tt[f"{key}_device"]])
        kernels[i]["library_device_ms_by_shape"] = by_shape(
            [lib for _, lib in tt[f"{key}_device"]])
    for i, kind in ((0, bilinear.forward_kind), (1, bilinear.dcoords_kind),
                    (2, bilinear.dimg_kind)):
        kernels[i]["kind_by_shape"] = by_shape(
            [kind(*shape[1:4]) for shape in TRAIN_SHAPES])
    kernels[0]["sampling_plain_ms_by_shape"] = dict(
        zip(map(str, SAMPLER_SHAPES), t["plain_ms"]))
    # rows 4 and 6 run on the ladder training CLI's path (phase 13), rows
    # 3 and 5 on the per-layer route's train step (phase 14)
    main_path = {"LAUNCHES": per_layer["pallas"],
                 "DX_LAUNCHES": per_layer["pallas"],
                 "DCK_LAUNCHES": per_layer["pallas"]}
    stages = [stage_shape(i, TRAIN_B) for i in range(3)]

    def up_pattern(key: str, suffix: str = "") -> str:
        """The profiler name of an upsample-conv kernel's instantiations:
        the block forms' first flag (the forward's stats, dX's fold) is
        true. The bf16 dCK has one form (its first flag is the 16-byte
        copies); each route's step launches only its own."""
        op = "fwd" if key == "block" else key.removeprefix("block_")
        if suffix and op == "dck":
            return f"upsample_conv_dck{suffix}<"
        if suffix and op == "fwd":    # the cp.async or the TMA kernel
            return (f"upsample_conv_fwd{suffix}",
                    f"<{'true' if key == 'block' else 'false'}")
        return (f"upsample_conv_{op}{suffix}<"
                f"{'true' if key.startswith('block') else 'false'}")

    def up_times(rows) -> dict:
        """An upsample-conv kernel's times over the three stages, and each
        stage's."""
        names = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                 "library_device_ms")
        return {**{k: sum(r[k] for r in rows) for k in names},
                "bound_by": "operations" if all(
                    r["bound_by"] == "operations" for r in rows) else "bytes",
                **{f"{k}_by_shape": by_shape([r[k] for r in rows], stages)
                   for k in names}}

    def st_entry(name, err, rows, library, **extra) -> dict:
        """The ST-conv kernel's entry: the training path's times, the
        sampling path's beside them."""
        return {"name": name, "route": "cuda",
                "source": "catgen_torch/csrc/st_conv.cu",
                "replaces": "catgen/kernels/pallas_st_conv.py:154", **extra,
                "max_abs_err": err["out"], "max_rel_err": err["out_rel"],
                "z_max_abs_err": err["z"], "z_max_rel_err": err["z_rel"],
                "samp_max_abs_err": err["samp"], **rows["train"],
                "library": library, "shape": str(ST_SHAPES[0]),
                "sampling_path": {"shape": str(ST_SHAPES[1]),
                                  **rows["sample"]}}

    for key, name, counter, replaces, source in UP_KERNELS:
        path = main_path.get(counter, ladder_train)
        profiled = rt["per-layer" if counter in main_path else "ladder"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"catgen_torch/csrc/{source}", "replaces": replaces,
            "launches": path[counter],
            "launches_by_path": {
                "sample_ladder": ladder_sample[counter],
                "train_ladder": ladder_train[counter],
                "step_per_layer_pallas": per_layer["pallas"][counter],
                "step_per_layer_hybrid": per_layer["hybrid"][counter],
                "pretrain_ladder": pre_ladder[counter]},
            "max_abs_err": up_err[key],
            "max_rel_err": up_err[f"{key}_rel"],
            **({"max_rel_err_vs_float64": exact[key]}
               if key in exact else {}),
            **up_times(ut[key]),
            "bound_f32_ms": sum(r["bound_f32_ms"] for r in ut[key]),
            "bound_note": "3xTF32 on the tensor cores: 3 x 2 x MACs / "
                          "495e12; bound_f32_ms: 2 x MACs / 67e12",
            "device_ms_per_step": device_step_ms(profiled, up_pattern(key)),
        })
    kernels.append(st_entry(
        "st_conv_prelu", st_err, st_t,
        "split route: v4 sampler kernel + cuDNN conv2d + PReLU",
        launches=fused_train["st_conv"],
        launches_by_path={
            "sample_fused_prefix": fused_sample["st_conv"],
            "train_fused_prefix": fused_train["st_conv"],
            "step_card_vs_cpu": fused_step["launches"]["st_conv"]},
        cuda_kernel="st_conv_f32_tiled (a block per sample, the tile "
                    "sampled once, 4 output channels of 4 pixels a thread) "
                    "where st_conv.f32_kind says tiled (the prefix's "
                    "shapes), else st_conv_prelu_kernel (banded_ms, "
                    "banded_device_ms: the banded kernel on the same "
                    "inputs)",
        device_ms_per_step=device_step_ms(rd["fused-prefix"],
                                          "st_conv_f32_tiled")))
    also = {"fwd": ["catgen/kernels/pallas_bilinear_v2.py:135",
                    "catgen/kernels/pallas_bilinear_v3.py:126"],
            "bwd": ["catgen/kernels/pallas_bilinear_v2.py:171",
                    "catgen/kernels/pallas_bilinear_v3.py:162"]}
    for key, name, counter, pattern in (
            ("fwd", "bilinear_sample_grid", "LAUNCHES", "sample_per"),
            ("dcoords", "bilinear_sample_grid_bwd_dcoords",
             "DCOORDS_LAUNCHES", "dcoords_"),
            ("dimg", "bilinear_sample_grid_bwd_dimg", "DIMG_LAUNCHES",
             "dimg_")):
        bounds = [sampler_bound(key, shape) for shape in TRAIN_SHAPES]
        kernels.append({
            "name": name, "route": "cuda",
            "source": source_fwd if key == "fwd" else source_bwd,
            "replaces": ("catgen/kernels/pallas_bilinear.py:72" if key == "fwd"
                         else "catgen/kernels/pallas_bilinear.py:171"),
            "also_replaces": also["fwd" if key == "fwd" else "bwd"],
            "launches": grid_train[counter],
            "launches_by_path": {
                "sample_v1": grid_sample[counter],
                "train_v1": grid_train[counter],
                "step_v2": gen_steps["v2"][counter],
                "step_v3": gen_steps["v3"][counter],
                "train_v": v_counts[counter]},
            "max_abs_err": grid_err[key],
            "ms": sum(gt[key]), "plain_ms": sum(gt[f"{key}_plain"]),
            "bound_ms": sum(b for b, _ in bounds), "bound_by": "bytes",
            "library_ms": sum(gt[f"{key}_library"]),
            "device_ms_per_step": device_step_ms(
                rd["grid-v1"], (pattern, "GridLayout")),
            "ms_by_shape": by_shape(gt[key]),
            "plain_ms_by_shape": by_shape(gt[f"{key}_plain"]),
            "library_ms_by_shape": by_shape(gt[f"{key}_library"]),
            "bound_ms_by_shape": by_shape([b for b, _ in bounds]),
        })
        if key == "fwd":   # phase 21: the V warp generator's grids
            kernels[-1]["warp_shape_max_abs_err"] = warp_err
        kernels[-1]["device_ms_by_shape"] = by_shape(
            [k for k, _ in gt[f"{key}_device"]])
        kernels[-1]["library_device_ms_by_shape"] = by_shape(
            [lib for _, lib in gt[f"{key}_device"]])
    # the bf16 instantiations (phases 26-29): the rows kernels on the bf16
    # training CLI's path, the grid kernels on one bf16 v1 step
    for layout, counts, prefix in (("rows", bf16_train, ""),
                                   ("grid", bf16_grid, "grid_")):
        for key, counter in (("fwd", "BF16_LAUNCHES"),
                             ("dcoords", "BF16_DCOORDS_LAUNCHES"),
                             ("dimg", "BF16_DIMG_LAUNCHES")):
            base = {"fwd": f"bilinear_sample_{layout}",
                    "dcoords": f"bilinear_sample_{layout}_bwd_dcoords",
                    "dimg": f"bilinear_sample_{layout}_bwd_dimg"}[key]
            bounds = [sampler_bound(key, shape, 2)[0]
                      for shape in TRAIN_SHAPES]
            v4 = "catgen/kernels/pallas_bilinear_v4.py"
            v1 = "catgen/kernels/pallas_bilinear.py"
            kernels.append({
                "name": f"{base}_bf16", "route": "cuda",
                "source": source_fwd if key == "fwd" else source_bwd,
                "replaces": (f"{v4}:799" if key == "fwd" else f"{v4}:917")
                if layout == "rows" else
                (f"{v1}:72" if key == "fwd" else f"{v1}:171"),
                "launches": counts[prefix + counter],
                "launches_by_path": {
                    ("train_bf16" if layout == "rows" else "step_v1_bf16"):
                    counts[prefix + counter]},
                "max_abs_err": bf16_err[key],
                **({"max_ulps": bf16_err[f"{key}_ulps"]}
                   if key != "fwd" else {}),
                "ms": sum(bt[f"{layout}_{key}"]),
                "plain_ms": sum(bt[f"{layout}_{key}_plain"]),
                "bound_ms": sum(bounds), "bound_by": "bytes",
                "library_ms": sum(bt[f"{layout}_{key}_library"]),
                "ms_by_shape": by_shape(bt[f"{layout}_{key}"]),
                "plain_ms_by_shape": by_shape(bt[f"{layout}_{key}_plain"]),
                "library_ms_by_shape": by_shape(
                    bt[f"{layout}_{key}_library"]),
                "bound_ms_by_shape": by_shape(bounds),
                **({"device_ms_by_shape": by_shape(
                        [k for k, _ in bt[f"rows_{key}_device"]]),
                    "library_device_ms_by_shape": by_shape(
                        [lib for _, lib in bt[f"rows_{key}_device"]])}
                   if layout == "rows" else {}),
            })
            if key == "dcoords":
                kernels[-1]["cuda_kernel"] = (
                    "dcoords_per_quad_bf16 (a block per sample, the image "
                    "widened in shared memory, 4 output pixels a thread, "
                    "the per-pixel kernel's bits) at C < 32, "
                    "dcoords_staged at the branch shape")
                kernels[-1]["kind_by_shape"] = by_shape(
                    [bilinear.dcoords_kind(*shape[1:4], torch.bfloat16)
                     for shape in TRAIN_SHAPES])
    # the bf16 instantiations of rows 3-7 (phases 30-33): the block kernels
    # on the bf16 ladder training CLI's path, the per-layer kernels on one
    # bf16 per-layer step, the ST-conv kernel on the bf16 fused-prefix CLI
    ladder16, fused16 = bf16_cli["ladder"][0], bf16_cli["fused-prefix"][0]
    per_layer16 = bf16_route_steps["per-layer"]["launches"]
    for key, name, counter, replaces, source in BF16_UP_KERNELS:
        block = key.startswith("block")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"catgen_torch/csrc/{source}", "replaces": replaces,
            "launches": (ladder16 if block else per_layer16)[f"up_{counter}"],
            "launches_by_path": {
                "train_ladder_bf16": ladder16[f"up_{counter}"],
                **{f"step_{r.replace('-', '_').replace(' ', '_')}_bf16":
                   bf16_route_steps[r]["launches"][f"up_{counter}"]
                   for r, _ in BF16_ROUTES}},
            "max_abs_err": bf16_up_err[key],
            "max_rel_err": bf16_up_err[f"{key}_rel"],
            **({"max_rel_err_vs_float64": exact16[key]}
               if key in exact16 else {}),
            **up_times(bkt[key]),
            "device_ms_per_step": device_step_ms(
                {"device_ms": brt["ladder" if block else "per-layer"][
                    "kernel_device_ms"]}, up_pattern(key, "_bf16")),
        })
        if key in ("fwd", "block"):
            kernels[-1]["cuda_kernel"] = (
                "upsample_conv_fwd_bf16_tma (TMA boxes, mbarrier ring, "
                "two accumulator banks) where fwd_bf16_box gives a box, "
                "else upsample_conv_fwd_bf16")
            kernels[-1]["kernel_by_shape"] = fwd16_kinds
        if key == "block_dx":
            kernels[-1]["block_backward"] = {
                "what": "fused_block_backward in one call: the fold pass, "
                        "this kernel on its output, the transform pass and "
                        "dCK; library: cuDNN's bf16 dgrad and wgrad in one "
                        "call", **up_times(bkt["block_backward"])}
    # the bf16 block's passes (phases 30, 32, 33): on the bf16 ladder
    # training CLI's path
    for key, name, counter, replaces, also in BF16_PASSES:
        rows = bkt[key]
        names = ("ms", "plain_ms", "bound_ms", "device_ms")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "catgen_torch/csrc/upsample_conv_prep.cu",
            "replaces": replaces, **({"also_replaces": also} if also else {}),
            "launches": ladder16[f"up_{counter}"],
            "launches_by_path": {
                "train_ladder_bf16": ladder16[f"up_{counter}"],
                **{f"step_{r.replace('-', '_').replace(' ', '_')}_bf16":
                   bf16_route_steps[r]["launches"][f"up_{counter}"]
                   for r, _ in BF16_ROUTES}},
            "max_abs_err": pass_err[key],
            **({"dbias_max_abs_err": pass_err["fold_dbias"]}
               if key == "fold" else {}),
            **{k: sum(r[k] for r in rows) for k in names},
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": None, "library_note": "no one PyTorch call "
            "computes the pass",
            **{f"{k}_by_shape": by_shape([r[k] for r in rows], stages)
               for k in names},
            "device_ms_per_step": device_step_ms(
                {"device_ms": brt["ladder"]["kernel_device_ms"]},
                f"upsample_conv_{key}_bf16"),
        })
    kernels.append(st_entry(
        "st_conv_prelu_bf16", bf16_st_err, st16,
        "split route in bf16: bf16 v4 sampler kernel + cuDNN conv2d + PReLU",
        launches=fused16["st_conv_bf16"],
        launches_by_path={
            "train_fused_prefix_bf16": fused16["st_conv_bf16"],
            "step_fused_prefix_bf16":
                bf16_route_steps["fused-prefix"]["launches"]["st_conv_bf16"]},
        cuda_kernel="st_conv_bf16_mma (the conv on mma.sync tensor cores)",
        device_ms_per_step=device_step_ms(
            {"device_ms": brt["fused-prefix"]["kernel_device_ms"]},
            "st_conv_bf16_mma")))
    # the 64px pyramid (phases 34-36): the shapes it gives the kernels and
    # their launches in its CLI runs on the kernel route
    by_name = {k["name"]: k for k in kernels}
    for dtype, suffix, prefix in (("f32", "", ""), ("bf16", "_bf16", "BF16_")):
        run = runs64[f"{dtype}_kernel"]["launches"]
        for key, name, counter, _, _ in UP_KERNELS:
            entry = by_name[name + suffix]
            entry["at_64px"] = {"launches_train_64px":
                                run[f"up_{prefix}{counter}"]}
            if key in refine_t[dtype]:
                entry["at_64px"].update(
                    shape=str(REFINE_SHAPE),
                    max_abs_err=refine_err[dtype][key],
                    max_rel_err=refine_err[dtype][f"{key}_rel"],
                    **refine_t[dtype][key])
            else:
                entry["at_64px"]["shape"] = "G64_stack's base (G32up-c)"
        rows = by_name["bilinear_sample_rows" + suffix]
        rows["at_64px"] = {
            "shape": str(SAMPLER64_SHAPE), **s64[dtype],
            "max_abs_err": s64[f"{dtype}_rows_max_abs_err"],
            "grid_max_abs_err": s64[f"{dtype}_grid_max_abs_err"],
            "launches_train_64px": runs64[f"{dtype}_default"]["launches"][
                f"{prefix}LAUNCHES"]}
    for _, name, counter, _, _ in BF16_PASSES:
        by_name[name]["at_64px"] = {"launches_train_64px": runs64[
            "bf16_kernel"]["launches"][f"up_{counter}"]}
    add_16px_entries(by_name, base64, new_err, new_t, s16, st16_err, st16_t,
                     steps16, runs16, zoo)
    # phase 40: each kernel's launches in one DP step of a world of one
    for key, run in world1.items():
        if key.startswith("time_"):
            continue
        bf16 = key.endswith("bf16")
        names = {"LAUNCHES": "bilinear_sample_rows",
                 "DCOORDS_LAUNCHES": "bilinear_sample_rows_bwd_dcoords",
                 "DIMG_LAUNCHES": "bilinear_sample_rows_bwd_dimg",
                 **{f"up_{counter}": name
                    for _, name, counter, _, _ in UP_KERNELS}}
        for counter, name in names.items():
            if bf16:
                counter = (counter.replace("up_", "up_BF16_")
                           if counter.startswith("up_") else f"BF16_{counter}")
                name += "_bf16"
            if run["launches"].get(counter):
                by_name[name]["launches_by_path"][f"dp_step_{key}"] = \
                    run["launches"][counter]
    print(json.dumps({"kernels": kernels}))
    print(card_name)     # as nvidia-smi gives it: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
