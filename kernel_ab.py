"""Two checkouts' kernels side by side on one NVIDIA GPU: outputs bit for
bit and device times, in one call.

    python3 kernel_ab.py run --root DIR --out FILE
    python3 kernel_ab.py compare FILE_A FILE_B [FILE_A2 FILE_B2 ...]

``run`` imports catgen_torch from the checkout at DIR (its kernels are
built from DIR's sources into DIR/catgen_torch/_build) and runs, at
G32up-c's three stage shapes at B=640, the bf16 upsample-conv forward
(per layer with bias and a per-channel PReLU, and as the block with its
transform pass and the statistics), the f32 forward per layer, and the
bf16 backward (the per-layer dX, the block dX kernel on the folded
cotangent, and the whole block backward: fold pass, dX, transform pass,
dCK); the ST-conv prefix at D32_st3's training shape (640, 32, 32, 3) ->
64 with samp and z and at its sampling shape (256, ...) with out alone,
in bf16 and f32; and the sampler forward and d_coords at the input ST's
shape (640, 32, 32, 3) -> 32x32 in f32 and bf16, rows and grid layouts.
Inputs come
from fixed seeds. It saves a SHA-256 of every output's bytes and each
call's time to FILE: device time from the profiler (the kernels' own
time per call, in all and by kernel, over 20 calls of an upsample-conv,
200 of a sampler forward or an ST-conv, after 3 warm-up calls) and CUDA
events over back-to-back calls (median of 5, the wrapper's host work
included). Run it for two checkouts in turns (A, B, B, A), then
``compare`` prints which outputs are equal bit for bit and each time
beside the other's, the runs of one checkout averaged. Both checkouts'
entry points must be those of the same wrappers
(``fused_upsample_conv.upsample2_conv_fused``,
``upsample2_conv_block_fused``, ``upsample2_conv_dx``, ``_launch_dx``,
``fused_block_backward``, ``st_conv.launch``, ``bilinear.launch``,
``bilinear_grid.launch``, ``bilinear.launch_dcoords``,
``bilinear_grid.launch_dcoords``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys

B = 640
STAGES = [(512, 512, 3, 4), (512, 256, 3, 8), (256, 128, 5, 16)]


def _ms(fn, reps: int = 5, inner: int = 20, warmup: int = 3) -> float:
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


def _device_ms(fn, calls: int, warmup: int = 3) -> tuple:
    """The device time of the kernels ``fn`` launches, per call, and each
    kernel's by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / calls / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    return sum(kernels.values()), kernels


def _digest(t) -> str:
    import torch

    t = t.detach().contiguous().cpu()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return (f"{t.dtype} {tuple(t.shape)} "
            f"{hashlib.sha256(raw.numpy().tobytes()).hexdigest()}")


def _stage_inputs(s: int):
    import torch

    cin, cout, k, hw = STAGES[s]
    gen = torch.Generator("cuda").manual_seed(500 + s)

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=gen, device="cuda") * scale

    v = dict(x=randn(B, hw, hw, cin),
             weight=randn(cout, cin, k, k, scale=(cin * k * k) ** -0.5),
             bias=randn(cout, scale=0.1),
             scale=torch.rand(cin, generator=gen, device="cuda") + 0.5,
             shift=randn(cin, scale=0.3),
             alpha=torch.rand(1, generator=gen, device="cuda") * 0.5,
             prelu=torch.rand(cout, generator=gen, device="cuda") * 0.5,
             gy=randn(B, 2 * hw, 2 * hw, cout))
    out = {key: t.bfloat16() for key, t in v.items()}
    out["gs1"], out["gs2"] = randn(cout, scale=0.01), randn(cout, scale=0.01)
    return out


def run(root: str, out: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import catgen_torch
    from catgen_torch.kernels import bilinear, bilinear_grid, st_conv
    from catgen_torch.kernels import fused_upsample_conv as fuc

    here = os.path.dirname(os.path.abspath(catgen_torch.__file__))
    if not here.startswith(root + os.sep):
        raise SystemExit(f"catgen_torch came from {here}, not {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    outputs, times = {}, {}
    for s in range(3):
        v = _stage_inputs(s)
        x, w, gy = v["x"], v["weight"], v["gy"]
        y = fuc.block_plain(x, w, v["bias"], v["scale"], v["shift"],
                            v["alpha"])
        gf = fuc.block_fold(y, gy, v["gs1"], v["gs2"])[0]
        tr = (v["scale"], v["shift"], v["alpha"].expand(x.shape[3])
              .contiguous())
        x32, w32, b32, pr32 = (v[k].float() for k in ("x", "weight", "bias",
                                                       "prelu"))
        calls = {
            f"stage{s + 1}_fwd": lambda: (fuc.upsample2_conv_fused(
                x, w, v["bias"], v["prelu"]),),
            f"stage{s + 1}_block_fwd": lambda: fuc.upsample2_conv_block_fused(
                x, w, v["bias"], v["scale"], v["shift"], v["alpha"]),
            f"stage{s + 1}_fwd_f32": lambda: (fuc.upsample2_conv_fused(
                x32, w32, b32, pr32),),
            f"stage{s + 1}_dx": lambda: (fuc.upsample2_conv_dx(x, w, gy),),
            f"stage{s + 1}_block_dx_on_gf": lambda: fuc._launch_dx(
                x, w, gf, None, None, *tr),
            f"stage{s + 1}_block_backward": lambda: fuc.fused_block_backward(
                x, v["scale"], v["shift"], v["alpha"], w, y, gy, v["gs1"],
                v["gs2"])}
        for key, fn in calls.items():
            outputs[key] = [_digest(t) for t in fn()]
            dev, kernels = _device_ms(fn, calls=20)
            times[key] = {"device_ms": dev, "event_ms": _ms(fn),
                          "kernels": kernels}
        del v, x, w, gy, y, gf, calls, x32, w32, b32, pr32
        torch.cuda.empty_cache()
    for n, save in ((B, True), (256, False)):
        gen = torch.Generator("cuda").manual_seed(700 + n)
        ang = (torch.rand(n, generator=gen, device="cuda") - 0.5) * 0.6
        sc = 0.85 + 0.3 * torch.rand(n, generator=gen, device="cuda")
        ty, tx = ((torch.rand(n, generator=gen, device="cuda") - 0.5) * 0.3
                  for _ in range(2))
        cos, sin = torch.cos(ang) * sc, torch.sin(ang) * sc
        theta = torch.stack([torch.stack([cos, -sin, ty], -1),
                             torch.stack([sin, cos, tx], -1)], 1).contiguous()
        img = torch.rand((n, 32, 32, 3), generator=gen, device="cuda")
        kern = torch.randn((3, 3, 3, 64), generator=gen, device="cuda") * 0.3
        bias = torch.randn((64,), generator=gen, device="cuda") * 0.1
        alpha = torch.rand((64,), generator=gen, device="cuda") * 0.5
        for dtype in (torch.bfloat16, torch.float32):
            im = img.to(dtype)
            key = (f"st_conv_{n}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
                   f"{'' if save else '_out_only'}")

            def fn(im=im):
                return tuple(t for t in st_conv.launch(
                    im, theta, kern, bias, alpha, save=save) if t is not None)

            outputs[key] = [_digest(t) for t in fn()]
            dev, kernels = _device_ms(fn, calls=200)
            times[key] = {"device_ms": dev, "event_ms": _ms(fn, inner=200),
                          "kernels": kernels}
    gen = torch.Generator("cuda").manual_seed(600)
    img = torch.rand((B, 32, 32, 3), generator=gen, device="cuda")
    rows = torch.rand((B, 2, 1024), generator=gen, device="cuda") * 2.4 - 1.2
    cot = torch.rand((B, 32, 32, 3), generator=gen, device="cuda") * 2 - 1
    for dtype in (torch.float32, torch.bfloat16):
        im, r, g = img.to(dtype), rows.to(dtype), cot.to(dtype)
        grid = r.permute(0, 2, 1).reshape(B, 32, 32, 2).contiguous()
        tag = "f32" if dtype == torch.float32 else "bf16"
        calls = {f"sampler_fwd_rows_{tag}":
                 lambda im=im, r=r: (bilinear.launch(im, r, (32, 32)),),
                 f"sampler_fwd_grid_{tag}":
                 lambda im=im, grid=grid: (bilinear_grid.launch(im, grid),),
                 f"sampler_dcoords_rows_{tag}":
                 lambda im=im, r=r, g=g: (bilinear.launch_dcoords(
                     im, r, g, (32, 32)),),
                 f"sampler_dcoords_grid_{tag}":
                 lambda im=im, grid=grid, g=g: (bilinear_grid.launch_dcoords(
                     im, grid, g),)}
        for key, fn in calls.items():
            outputs[key] = [_digest(t) for t in fn()]
            dev, kernels = _device_ms(fn, calls=200)
            times[key] = {"device_ms": dev, "event_ms": _ms(fn, inner=200),
                          "kernels": kernels}
    with open(out, "w") as f:
        json.dump({"root": root, "card": torch.cuda.get_device_name(0),
                   "outputs": outputs, "times": times}, f)
    for key, ms in times.items():
        print(f"{root}: {key} device {ms['device_ms']:.4f} ms, events "
              f"{ms['event_ms']:.4f} ms; by kernel: " + ", ".join(
                  f"{name[:60]} {t:.4f}" for name, t in sorted(
                      ms["kernels"].items(), key=lambda kv: -kv[1])))


def compare(files) -> None:
    runs = []
    for name in files:
        with open(name) as f:
            runs.append(json.load(f))
    roots = sorted({r["root"] for r in runs})
    if len(roots) != 2:
        raise SystemExit(f"need runs of two checkouts, got {roots}")
    by_root = {root: [r for r in runs if r["root"] == root] for root in roots}
    first = {root: rs[0]["outputs"] for root, rs in by_root.items()}
    a, b = roots
    print(f"A = {a} ({len(by_root[a])} runs), B = {b} ({len(by_root[b])} "
          f"runs); {runs[0]['card']}")
    for key in first[a]:
        same = first[a][key] == first[b][key]
        repeat = all(r["outputs"][key] == rs[0]["outputs"][key]
                     for rs in by_root.values() for r in rs)
        line = [f"{key}: bits equal A/B {same}, within each {repeat}"]
        for what in ("device_ms", "event_ms"):
            ta = [r["times"][key][what] for r in by_root[a]]
            tb = [r["times"][key][what] for r in by_root[b]]
            line.append(f"{what} A {' '.join(f'{t:.4f}' for t in ta)}, B "
                        f"{' '.join(f'{t:.4f}' for t in tb)}, B/A of the "
                        f"means {statistics.mean(tb) / statistics.mean(ta):.3f}")
        print("; ".join(line))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run")
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("files", nargs="+")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    if args.cmd == "run":
        run(args.root, args.out)
    else:
        compare(args.files)
    return 0


if __name__ == "__main__":
    sys.exit(main())
